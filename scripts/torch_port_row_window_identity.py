"""Hold the single-device row-tiled kernels (#3, #4 and their backward #5) of
this checkout bit for bit against another checkout's, on one NVIDIA card.

    python3 scripts/torch_port_row_window_identity.py --other <checkout>

Each tree runs in its own interpreter, with its own package and kernel
build, on the same seeded inputs: GEOM widths (H=256, attention) at N=80
and 184 with ragged masks, 'sum', 'mean' and sin features, forward and
backward, the backward also in groups of one molecule. Every output's sha256
is compared; the script prints one JSON line and exits non-zero on any
difference. Used to show that a change to the kernels' sources (here the
row window of the sequence-parallel slabs) leaves these kernels' arithmetic
as it was.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

CASES = [("sum", 184, {}), ("sum", 80, {}), ("mean", 181, {"aggregation_method": "mean"}),
         ("sin", 80, {"sin_embedding": True})]


def _dump(root: str) -> dict:
    """sha256 of every output of #3, #4 and #5 with ``root``'s package."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from geoldm_tpu_torch.config import EGNNConfig
    from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters
    from geoldm_tpu_torch.ops import egnn_tiled

    assert egnn_tiled.__file__.startswith(os.path.abspath(root)), egnn_tiled.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}

    def digest(name, t):
        out[name] = hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()

    for case, n, extra in CASES:
        cfg = EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=256, n_layers=1,
                         normalization_factor=1.0, **extra)
        block = EquivariantBlock(cfg)
        init_parameters(block, torch.Generator().manual_seed(n))
        block = block.to(dev)
        rng = np.random.default_rng(n)
        b = 4
        n_real = rng.integers(n - 16, n + 1, size=b)
        mask = (np.arange(n)[None] < n_real[:, None]).astype(np.float32)[..., None]
        h, x, x0 = (rng.standard_normal((b, n, f)).astype(np.float32) * mask
                    for f in (256, 3, 3))
        args = [torch.from_numpy(a).to(dev) for a in (h, x, x0, mask)]
        gh, gx = (torch.from_numpy(rng.standard_normal((b, n, f)).astype(np.float32)).to(dev)
                  for f in (256, 3))
        with torch.no_grad():
            digest(f"{case}{n}/gcl_rows", egnn_tiled.gcl_rows_cuda(block.gcl_0, *args))
            digest(f"{case}{n}/coord_rows", egnn_tiled.coord_rows_cuda(block.gcl_equiv, *args))
        full_cap = egnn_tiled.MAX_BWD_SCRATCH_BYTES
        for groups, cap in (("", full_cap), ("/groups", None)):
            if cap is None:  # room for one molecule: the batch runs in groups of one
                from geoldm_tpu_torch.ops import cuda_build

                cap = 4 * cuda_build.library("egnn_tiled_bwd").egnn_rows_backward_scratch_floats(
                    1, n, 256, cfg.edge_feat_nf)
            egnn_tiled.MAX_BWD_SCRATCH_BYTES = cap
            for stage, mod, g in (("gcl_rows", block.gcl_0, gh), ("coord_rows", block.gcl_equiv,
                                                                  gx)):
                dh, dx, dx0, dws = getattr(egnn_tiled, f"{stage}_backward_cuda")(mod, *args, g)
                for name, t in zip(["dh", "dx", "dx0"] + [f"w{k}" for k in range(len(dws))],
                                   [dh, dx, dx0, *dws]):
                    digest(f"{case}{n}/{stage}_bwd{groups}/{name}", t)
        egnn_tiled.MAX_BWD_SCRATCH_BYTES = full_cap
    torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", required=True, help="root of the other checkout")
    p.add_argument("--dump", help=argparse.SUPPRESS)  # internal: one tree's digests
    args = p.parse_args(argv)
    if args.dump:
        print(json.dumps(_dump(args.dump)))
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = {root: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--other", "-",
                                     "--dump", root], stdout=subprocess.PIPE, text=True)
             for root in (here, os.path.abspath(args.other))}
    digests = {}
    for root, proc in procs.items():
        stdout, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"row_window_identity: the run of {root} failed", file=sys.stderr)
            return 1
        digests[root] = json.loads(stdout.strip().splitlines()[-1])
    mine, other = digests[here], digests[os.path.abspath(args.other)]
    differ = sorted(k for k in mine if mine[k] != other.get(k))
    print(json.dumps({"outputs": len(mine), "identical": len(mine) - len(differ),
                      "differ": differ}))
    return 1 if differ or set(mine) != set(other) else 0


if __name__ == "__main__":
    sys.exit(main())
