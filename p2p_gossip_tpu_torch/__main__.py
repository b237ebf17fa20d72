"""``python -m p2p_gossip_tpu_torch`` — the simulation CLI."""

from p2p_gossip_tpu_torch.utils.cli import main

main()
