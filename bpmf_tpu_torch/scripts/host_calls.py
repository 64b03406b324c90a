"""The host's Python work per iteration of a chain: the Python-level calls
and the calls of built-in (C) functions, torch's operators among them,
that one iteration of ``BPMF.run_chunk`` makes, counted with
``sys.setprofile``.  A count, not a time: it reads the same on any host,
so two checkouts compare on the CPU, where a time would say nothing of the
card.

    python bpmf_tpu_torch/scripts/host_calls.py [--root DIR] [--device cpu]
        [--data tiny|ml1m] [-d K] [--iters N]

Imports ``bpmf_tpu_torch`` from DIR (default: the checkout this file lies
in) and prints one JSON line.  ``tiny`` is the entry points' chain
(``__graft_entry__.py``'s data, K=16), ``ml1m`` the ml-1m synth.
"""

import argparse
import io
import json
import os
import sys


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)),
                    help="the checkout whose bpmf_tpu_torch is counted")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--data", default="tiny", choices=("tiny", "ml1m"))
    ap.add_argument("-d", "--num-latent", type=int, default=16)
    ap.add_argument("--iters", type=int, default=10)
    a = ap.parse_args(argv)
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch

    import bpmf_tpu_torch
    from bpmf_tpu_torch import Config, synth_movielens
    from bpmf_tpu_torch.sampler import BPMF

    assert os.path.dirname(os.path.dirname(bpmf_tpu_torch.__file__)) == root
    torch.set_num_threads(1)
    kw = (dict(n_users=96, n_movies=64, n_ratings=1500, seed=7)
          if a.data == "tiny" else {})
    train, test = synth_movielens(**kw)
    s = BPMF(Config(num_latent=a.num_latent, burnin=1, nsims=a.iters + 4),
             train, test, out=io.StringIO(), device=a.device)
    s.setup()
    s.run_chunk(3)                      # warm: first-use builds and caches
    counts = {"call": 0, "c_call": 0}

    def count(frame, event, arg):
        if event in counts:
            counts[event] += 1

    sys.setprofile(count)
    try:
        s.run_chunk(a.iters)
    finally:
        sys.setprofile(None)
    print(json.dumps({"root": root, "data": a.data, "k": a.num_latent,
                      "device": a.device, "routes": [s.movies.route, s.users.route],
                      "iterations": a.iters,
                      "python_calls_per_iter": counts["call"] / a.iters,
                      "c_calls_per_iter": counts["c_call"] / a.iters}))


if __name__ == "__main__":
    main()
