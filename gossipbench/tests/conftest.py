"""The tiny sizes of the push-pull cells, added to `tiny`'s tables before
any test of this folder lays out a tiny checkout (`tiny.write_root`
copies every cell of ``BENCHMARK.json``)."""

from gossipbench.tests import tiny

tiny.GRAPHS.setdefault("ba1m-lognormal", {"n": 1500})
tiny.TRAFFIC.setdefault("pushpull-coverage4k", {
    "gen": {"kind": "uniform_ticks", "shares": 96, "lo": 0, "hi": 1},
    "horizon": 24, "chunk_size": 64})
tiny.TRAFFIC.setdefault("campaign8", {
    "gen": {"kind": "uniform_ticks", "shares": 160, "lo": 0, "hi": 1},
    "horizon": 16, "replicas": 3})
