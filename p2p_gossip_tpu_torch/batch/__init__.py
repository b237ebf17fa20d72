"""Monte-Carlo campaigns on the port: R seed replicas of a simulation in
batches through the same kernels, reduced to ensemble statistics (the JAX
package's ``batch/``):

- ``batch.campaign`` — replica-set builders and the batched runners
  (coverage campaigns with per-replica coverage history, gossip campaigns
  chunked over the share axis, the random-partner protocols), which also
  split a batch's replicas over the ranks of a ``mesh=``;
- ``batch.campaign_sharded`` — R replicas of the node-sharded flood and
  protocols over a factorized (replicas, nodes) mesh of ranks;
- ``batch.stats``    — time-to-coverage percentiles, counter confidence
  intervals, redundancy distributions;
- ``batch.sweep``    — parameter-grid sweeps over {protocol, p, lossProb,
  churnProb, fanout} x seeds, one JSON record per cell.

Replica r of a campaign is bitwise the solo run with its seeds.
"""

from p2p_gossip_tpu_torch.batch.campaign import (
    CampaignResult,
    ReplicaSet,
    flood_replicas,
    gossip_replicas,
    run_coverage_campaign,
    run_gossip_campaign,
    run_protocol_campaign,
)
from p2p_gossip_tpu_torch.batch.campaign_sharded import (
    run_sharded_campaign,
    run_sharded_protocol_campaign,
)
from p2p_gossip_tpu_torch.batch.stats import ensemble_summary, format_campaign_report

__all__ = [
    "CampaignResult",
    "ReplicaSet",
    "flood_replicas",
    "gossip_replicas",
    "run_coverage_campaign",
    "run_gossip_campaign",
    "run_protocol_campaign",
    "run_sharded_campaign",
    "run_sharded_protocol_campaign",
    "ensemble_summary",
    "format_campaign_report",
]
