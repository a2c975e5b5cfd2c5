#!/usr/bin/env python3
"""Where a `PairAveragingHost` step's host time goes: the libkf store
path and the copies around it, at GPT-2-small's fused model size.

    python3 scripts/torch_pair_wire.py [--mb 652.35] [--reps 3]
        [--device cuda]

Two of the port's libkf peers in one process (the serving peer's
requests are answered by its native server thread, as in a worker)
move one f32 vector of ``--mb`` MB (default: GPT-2-small's 163,087,457
parameters). Each rep times, in ms:

- ``save``: `Peer.save` of the vector (the store copies it);
- ``request``: `Peer.request` of it from the other peer, idle, and
  ``request_busy``: the same while the serving peer saves it twice more
  (a pair step saves twice while its peer pulls);
- ``fresh_touch``: filling a newly allocated vector of the same size
  (the first touch of every page, which each request's output and
  receive buffers pay), and ``memcpy``: one copy between warm vectors;
- on the card: ``h2d_pageable`` (the fetched vector to the card, as
  `mix` does it), ``h2d_pinned`` and ``d2h_pinned`` (the save's copy).

Prints the medians over the reps, the bytes each link class (tcp,
unix, shm) carried during the idle requests, and the card's name and
power limit; then one JSON line. ``--device cpu`` leaves out the card
copies.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

GPT2_SMALL_PARAMS = 163_087_457


def _ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _on_both(peers, fn):
    out, errors = [None] * len(peers), []

    def work(i):
        try:
            out[i] = fn(peers[i], i)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    ts = [threading.Thread(target=work, args=(i,)) for i in range(len(peers))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    if errors:
        raise errors[0]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=float, default=GPT2_SMALL_PARAMS * 4 / 1e6)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from kungfu_tpu_torch import env as kfenv
    from kungfu_tpu_torch.elastic.harness import claim_port_span
    from kungfu_tpu_torch.peer import Peer
    from kungfu_tpu_torch.plan import PeerList

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu")
    n = int(args.mb * 1e6 / 4)
    x = np.arange(n, dtype=np.float32)
    like = np.zeros_like(x)
    rows = []
    with claim_port_span() as span:
        base = int(span.split("-")[0])
        plist = PeerList.parse(f"127.0.0.1:{base},127.0.0.1:{base + 1}")
        peers = [Peer(kfenv.Config(self_id=plist[i], init_peers=plist,
                                   timeout_ms=120000)) for i in range(2)]
        _on_both(peers, lambda p, i: p.start())
        try:
            link0 = peers[1].link_stats()["ingress"]
            for _ in range(args.reps):
                row = {"save": _ms(lambda: peers[0].save("m", x))}
                got = {}
                row["request"] = _ms(
                    lambda: got.update(y=peers[1].request(0, "m", like)))
                assert np.array_equal(got["y"], x)
                saver = threading.Thread(
                    target=lambda: [peers[0].save("m", x) for _ in range(2)])
                saver.start()
                row["request_busy"] = _ms(
                    lambda: peers[1].request(0, "m", like))
                saver.join()
                row["fresh_touch"] = _ms(
                    lambda: np.empty(n, np.float32).fill(1.0))
                dst = np.empty_like(x)
                np.copyto(dst, x)
                row["memcpy"] = _ms(lambda: np.copyto(dst, x))
                if args.device == "cuda":
                    dev = torch.device("cuda")
                    pinned = torch.empty(n, pin_memory=True)
                    on_card = torch.empty(n, device=dev)
                    torch.cuda.synchronize()

                    def copy(fn):
                        def run():
                            fn()
                            torch.cuda.synchronize()
                        return _ms(run)

                    row["h2d_pageable"] = copy(
                        lambda: torch.from_numpy(got["y"]).to(dev))
                    row["h2d_pinned"] = copy(lambda: on_card.copy_(pinned))
                    row["d2h_pinned"] = copy(lambda: pinned.copy_(on_card))
                rows.append(row)
            link1 = peers[1].link_stats()["ingress"]
            _on_both(peers, lambda p, i: p.barrier())
        finally:
            for p in peers:
                p.close()
    med = {k: sorted(r[k] for r in rows)[len(rows) // 2] for k in rows[0]}
    links = {c: link1[c] - link0[c] for c in link1}
    card = "cpu only"
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    for k, v in med.items():
        print(f"{k:14s} {v:10.2f} ms  "
              f"({n * 4 / 1e6 / v:.3f} GB/s; reps "
              f"{[round(r[k], 2) for r in rows]})")
    print(f"ingress bytes by link class over the reps: {json.dumps(links)}")
    print(card)
    print(json.dumps({"bytes": n * 4, "reps": args.reps, "median_ms": med,
                      "ingress_by_link": links, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
