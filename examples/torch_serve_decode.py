"""Serve a small LM with batched requests through the port's decode
server.

Run:  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu] [--full]

The counterpart of `examples/serve_decode.py`: the same request stream
is served twice -- once under the ``fifo`` arrival-order oracle, once
under the ``homed`` scheduler that routes, batches and evicts by each
slot's cache home -- and the decoded tokens are asserted bit-identical
(a fixed ``prompt_pad`` makes every row's numerics independent of wave
composition), so the two policies differ only in waves, waits and
cross-home relayout bytes.  It serves ``reduce_config(granite-3-2b,
layers=4)``, as the reference does; ``--full`` serves granite-3-2b at
its full 40 layers, d 2048, in bfloat16.  The fixed ``prompt_pad``
makes the server page-step every prompt through `LM.decode_pages`, whose
attention is the plain decode form: this example launches none of the
port's kernels.  Served in aligned waves instead (``serve(cfg, params,
policy, prompt_pad=None)``), each wave's prefill runs its attention on
the `flash_attention` kernel, one launch a layer.  It runs on the card
by default; ``--device cpu`` runs the plain versions.  With no card and
no ``--device cpu`` it raises.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models import LM
from repro_torch.runtime.server import DecodeServer, Request

from torch_quickstart import device_of

POLICIES = ("fifo", "homed")
SERVER = dict(batch_slots=4, max_len=96, prompt_pad=8)


def config(full: bool = False):
    cfg = get_config("granite-3-2b")
    return cfg if full else reduce_config(cfg, layers=4)


def stream(cfg, n=10, sessions=3):
    rng = np.random.RandomState(0)
    return [Request(rid=rid,
                    prompt=rng.randint(0, cfg.vocab_size, rng.randint(2, 9))
                    .astype(np.int32),
                    max_new=int(rng.choice([4, 8])),
                    session=f"user{rng.randint(sessions)}",
                    t_arrive=float(rid // 4))
            for rid in range(n)]


def serve(cfg, params, policy: str, **server):
    """One policy's run of the stream: (server, served requests)."""
    srv = DecodeServer(cfg, params, scheduler=policy, **{**SERVER, **server})
    for r in stream(cfg):
        srv.submit(r)
    served = srv.run()
    assert all(r.done for r in served)
    return srv, served


def main(argv=None, params=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="granite-3-2b at full width and depth, bf16")
    args, rest = ap.parse_known_args(argv)
    dev = device_of(rest)
    cfg = config(args.full)
    if params is None:
        params = LM(cfg).init(torch.Generator(device=dev).manual_seed(0))
    outs = {}
    for policy in POLICIES:
        srv, served = serve(cfg, params, policy)
        outs[policy] = {r.rid: r.out for r in served}
        print(f"--- policy={policy}: {len(served)} requests, "
              f"{srv.scheduler.stats.waves} waves of {srv.B} slots ---")
        for r in sorted(served, key=lambda r: r.rid):
            print(f"req {r.rid} (session {r.session}, home {r.home}): "
                  f"-> {r.out}")
        print(srv.scheduler.format_summary())
    assert outs["fifo"] == outs["homed"], "policies must decode identically"
    print("fifo and homed decoded bit-identical tokens")
    return outs


if __name__ == "__main__":
    main()
