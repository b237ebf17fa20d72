"""The benchmark of the PyTorch and CUDA port (`p2p_gossip_tpu_torch`).

Run a cell with ``python3 -m gossipbench --workload NAME --seed N
--seconds S --trace 0|1``; `README.md` beside this file says how cells,
configurations, traffic mixes, entries and metrics are found by name.
"""
