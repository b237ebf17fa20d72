"""p2p_gossip_tpu_torch — the P2P gossip simulation on PyTorch and CUDA.

The flood engine of ``p2p_gossip_tpu`` (the JAX package, its reference)
rebuilt for an NVIDIA H100: the per-node seen-sets are (nodes x shares)
int32 bitmasks, one synchronous tick delivers every in-flight message
through a hand-written CUDA gather-OR kernel over the ELL adjacency
(``ops.ell``, ``ops.kernels``), and per-node counters and per-share
coverage come from CUDA popcount and coverage kernels. The engine's
options — node churn, link loss (its coin computed inside the gather
kernel), the connect window, periodic snapshots and checkpoint/resume —
follow the JAX engine's. The random-partner protocols (push-pull, pull,
fanout push; ``models.protocols``) push through a hand-written CUDA
scatter-OR kernel. Monte-Carlo campaigns (``batch``) run R seed replicas
stacked along the rows through the same kernels. Graphs, schedules, delays and the option models
are numpy, built from a seed exactly as in the JAX package, of which this
package imports nothing.
"""

from p2p_gossip_tpu_torch.models.topology import (
    Graph,
    erdos_renyi,
    barabasi_albert,
    ring_graph,
    complete_graph,
    watts_strogatz,
    grid_graph,
)
from p2p_gossip_tpu_torch.models.generation import (
    Schedule,
    poisson_schedule,
    single_share_schedule,
    uniform_renewal_schedule,
)
from p2p_gossip_tpu_torch.models.churn import (
    ChurnModel,
    always_up,
    effective_generated,
    from_intervals,
    random_churn,
)
from p2p_gossip_tpu_torch.models.latency import (
    constant_delays,
    lognormal_delays,
    serialization_delays,
)
from p2p_gossip_tpu_torch.models.linkloss import LinkLossModel
from p2p_gossip_tpu_torch.models.seeds import (
    churn_stream_seed,
    loss_stream_seed,
    replica_loss_seeds,
)
from p2p_gossip_tpu_torch.utils.analysis import (
    format_propagation_report,
    message_redundancy,
    propagation_latency,
)
from p2p_gossip_tpu_torch.utils.stats import NodeStats
from p2p_gossip_tpu_torch.models.protocols import (
    pushk_oracle,
    pushpull_oracle,
    seeded_partners,
)

# The engines stay behind an explicit module import, as in the JAX package:
#   from p2p_gossip_tpu_torch.engine.sync import run_sync_sim, run_flood_coverage
#   from p2p_gossip_tpu_torch.models.protocols import run_pushpull_sim, run_pushk_sim
#   from p2p_gossip_tpu_torch.batch import run_coverage_campaign, ensemble_summary

__version__ = "0.1.0"

__all__ = [
    "Graph",
    "erdos_renyi",
    "barabasi_albert",
    "ring_graph",
    "complete_graph",
    "watts_strogatz",
    "grid_graph",
    "Schedule",
    "uniform_renewal_schedule",
    "poisson_schedule",
    "single_share_schedule",
    "constant_delays",
    "lognormal_delays",
    "serialization_delays",
    "ChurnModel",
    "always_up",
    "from_intervals",
    "random_churn",
    "effective_generated",
    "LinkLossModel",
    "loss_stream_seed",
    "churn_stream_seed",
    "replica_loss_seeds",
    "propagation_latency",
    "format_propagation_report",
    "message_redundancy",
    "NodeStats",
    "seeded_partners",
    "pushpull_oracle",
    "pushk_oracle",
]
