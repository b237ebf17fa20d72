"""A run of the benchmark with the program broken underneath its timed
path, for the tests that see ``correct`` come out false:

    python -m gossipbench.tests.faulty FAULT <gossipbench arguments>

FAULT is one of `FAULTS`. In-process tests call `install` directly."""

from __future__ import annotations

import sys

FAULTS = ("unchanged", "half", "exchange", "altered")


def install(fault: str, monkeypatch=None):
    """Break the program (``monkeypatch.setattr`` when given, else
    ``setattr`` for the rest of the process)."""
    import torch

    from p2p_gossip_tpu_torch.engine import sync
    from p2p_gossip_tpu_torch.parallel import engine_sharded

    put = monkeypatch.setattr if monkeypatch is not None else setattr
    if fault == "unchanged":  # a tick that returns its state unchanged
        def unchanged(seen, arrivals, gen_bits, gen_cnt, received, sent, degree, *, out=None,
                      plain=False):
            newly = torch.zeros_like(seen) if out is None else out.zero_()
            return seen, newly, received, sent, torch.zeros_like(received)

        put(sync, "apply_tick_updates", unchanged)
        put(engine_sharded, "apply_tick_updates", unchanged)
    elif fault == "half":  # half of the batch left out: its shares never fire
        def halve(g, horizon):
            g = torch.as_tensor(g).clone()
            live = torch.nonzero(g.reshape(-1) < horizon).flatten()
            g.view(-1)[live[live.numel() // 2:]] = horizon
            return g

        loop, cov, pass_ = sync._run_chunk_while, sync._run_chunk_coverage, \
            engine_sharded._Runner.run_pass

        def run_while(dg, origins, gen_ticks, *a, horizon, **k):
            return loop(dg, origins, halve(gen_ticks, horizon), *a, horizon=horizon, **k)

        def run_cov(dg, origins, gen_ticks, *, horizon, **k):
            return cov(dg, origins, halve(gen_ticks, horizon), horizon=horizon, **k)

        def run_pass(self, origins, gen_ticks, t_start, last_gen, horizon, *a, **k):
            return pass_(self, origins, halve(gen_ticks, horizon).numpy(), t_start, last_gen,
                         horizon, *a, **k)

        put(sync, "_run_chunk_while", run_while)
        put(sync, "_run_chunk_coverage", run_cov)
        put(engine_sharded._Runner, "run_pass", run_pass)
    elif fault == "exchange":  # the exchange between cards left out
        def own_rows_only(out, local, group, async_op=False):
            import torch.distributed as dist

            n = local.shape[0]
            r = dist.get_rank(group)
            out.zero_()
            out[r * n:(r + 1) * n].copy_(local)
            return _Done() if async_op else None

        put(engine_sharded, "all_gather_rows", own_rows_only)
    elif fault == "altered":  # an answer altered where it is produced
        loop, cov = sync._run_chunk_while, sync._run_chunk_coverage

        def run_while(*a, **k):
            out = loop(*a, **k)
            out[1][0] += 1  # received of node 0
            return out

        def run_cov(*a, **k):
            out = cov(*a, **k)
            out[3][0, -1, 0] += 1  # the last coverage row of share 0
            return out

        put(sync, "_run_chunk_while", run_while)
        put(sync, "_run_chunk_coverage", run_cov)
    else:
        raise ValueError(f"unknown fault {fault!r}")


class _Done:
    def wait(self):
        return True


if __name__ == "__main__":
    install(sys.argv[1])
    from gossipbench.run import main

    sys.exit(main(sys.argv[2:]))
