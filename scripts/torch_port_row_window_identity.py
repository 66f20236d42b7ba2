"""Hold the EquivariantBlock kernels whose arithmetic a change must leave as
it was -- the whole-molecule kernels (#1 forward, #2 backward) and the
row-tiled forward stages (#3 GCL, #4 coordinate update, #6 on an SP slab) --
bit for bit against another checkout's, on one NVIDIA card.

    python3 scripts/torch_port_row_window_identity.py --other <checkout>

Each tree runs in its own interpreter, with its own package and kernel
build, on the same seeded inputs. #1/#2: QM9's and GEOM's pads up to 64 with
ragged masks, 'sum', 'mean' and sin features, two GCLs a block, and every
padded hidden width of the tile (64, 128, 256, 512); the forward, the
backward that recomputes the forward, and the training route (the forward
saving its activations, the backward from them). #3/#4/#6: GEOM's pads past
64 (N=96, 184 at H=256, 'sum' and 'mean'; N=130 at H=64 with sin features),
every row and the second half of the rows as an SP slab. Every output's
sha256 is compared; the script prints one JSON line and exits non-zero on
any difference.

#1/#2 and #3/#4/#6 share the tile machinery (``csrc/egnn_tile.cuh``) and
the one node GEMM (``egnn_tc_gemm.cuh``) with the row-tiled stage backward
(#5/#7), so a change there must leave them as they were. All of them run
their node-side products on that GEMM since #3/#4/#6 moved onto it, which
changed their bits on purpose (split TF32 and bf16 ``mma`` in place of f32
FMAs): the anchor for #3/#4/#6 is that change's commit, the same as #1/#2's
from then on. #5/#7 are held against their plain versions
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py`` phases 12 and 15).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

# (case, N, B, hidden_nf, config overrides)
CASES = [("sum", 16, 8, 256, {}), ("sum", 29, 8, 256, {}), ("sum", 32, 8, 256, {}),
         ("mean", 32, 8, 256, {"aggregation_method": "mean"}),
         ("sin", 24, 8, 256, {"sin_embedding": True}), ("sum", 48, 8, 256, {}),
         ("sum", 64, 8, 256, {}), ("gcl2", 17, 4, 64, {"inv_sublayers": 2}),
         ("no_att", 33, 4, 128, {"attention": False}), ("sum", 29, 4, 512, {})]
# The row-tiled forward stages: (case, N, hidden_nf, config overrides), B=4.
ROW_CASES = [("sum", 96, 256, {}), ("mean", 184, 256, {"aggregation_method": "mean"}),
             ("sin", 130, 64, {"sin_embedding": True})]


def _dump(root: str) -> dict:
    """sha256 of every output of #1, #2, #3, #4 and #6 with ``root``'s
    package."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from geoldm_tpu_torch.config import EGNNConfig
    from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters
    from geoldm_tpu_torch.ops import egnn_block

    assert egnn_block.__file__.startswith(os.path.abspath(root)), egnn_block.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}

    def digest(name, t):
        out[name] = hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()

    for case, n, b, hidden, extra in CASES:
        cfg = EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=hidden, n_layers=1,
                         normalization_factor=1.0, **{"attention": True, **extra})
        block = EquivariantBlock(cfg)
        init_parameters(block, torch.Generator().manual_seed(n + hidden))
        block = block.to(dev)
        rng = np.random.default_rng(n)
        n_real = rng.integers(max(1, n - 16), n + 1, size=b)
        mask = (np.arange(n)[None] < n_real[:, None]).astype(np.float32)[..., None]
        h, x, x0 = (rng.standard_normal((b, n, f)).astype(np.float32) * mask
                    for f in (hidden, 3, 3))
        args = [torch.from_numpy(a).to(dev) for a in (h, x, x0, mask)]
        gh, gx = (torch.from_numpy(rng.standard_normal((b, n, f)).astype(np.float32)).to(dev)
                  for f in (hidden, 3))
        key = f"{case}{n}h{hidden}"
        with torch.no_grad():
            h_out, x_out = egnn_block.block_forward_cuda(block, *args)
        digest(f"{key}/fwd/h", h_out)
        digest(f"{key}/fwd/x", x_out)
        h_s, x_s, saved = egnn_block._forward_launch(block, *args, save=True)
        digest(f"{key}/fwd_save/h", h_s)
        digest(f"{key}/fwd_save/x", x_s)
        digest(f"{key}/fwd_save/saved", saved)
        for route, grads in (("bwd", egnn_block.block_backward_cuda(block, *args, gh, gx)),
                             ("bwd_saved", egnn_block._backward_launch(block, *args, gh, gx,
                                                                       saved))):
            dh, dx, dx0, dws = grads
            for name, t in zip(["dh", "dx", "dx0"] + [f"w{k}" for k in range(len(dws))],
                               [dh, dx, dx0, *dws]):
                digest(f"{key}/{route}/{name}", t)
    from geoldm_tpu_torch.ops import egnn_sp, egnn_tiled

    with torch.no_grad():
        for case, n, hidden, extra in ROW_CASES:
            cfg = EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=hidden, n_layers=1,
                             normalization_factor=1.0, **{"attention": True, **extra})
            block = EquivariantBlock(cfg)
            init_parameters(block, torch.Generator().manual_seed(n + hidden))
            block = block.to(dev)
            rng = np.random.default_rng(n)
            n_real = rng.integers(n - 16, n + 1, size=4)
            mask = (np.arange(n)[None] < n_real[:, None]).astype(np.float32)[..., None]
            full = [torch.from_numpy(a).to(dev) for a in (
                *(rng.standard_normal((4, n, f)).astype(np.float32) * mask for f in (hidden, 3, 3)),
                mask)]
            key = f"rows_{case}{n}h{hidden}"
            digest(f"{key}/gcl", egnn_tiled.gcl_rows_cuda(block.gcl_0, *full))
            digest(f"{key}/coord", egnn_tiled.coord_rows_cuda(block.gcl_equiv, *full))
            row0 = n // 2
            rows = [t[:, row0:].contiguous() for t in full]
            for stage, mod in (("gcl", block.gcl_0), ("coord", block.gcl_equiv)):
                fwd, _ = egnn_sp.stage_fns(mod, True)
                digest(f"{key}/sp_{stage}", fwd(mod, full, rows, row0, n))
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
