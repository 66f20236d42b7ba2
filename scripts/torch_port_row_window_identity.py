"""Hold the whole-molecule EquivariantBlock kernels (#1 forward, #2 backward)
of this checkout bit for bit against another checkout's, on one NVIDIA card.

    python3 scripts/torch_port_row_window_identity.py --other <checkout>

Each tree runs in its own interpreter, with its own package and kernel
build, on the same seeded inputs: QM9's and GEOM's pads up to 64 with ragged
masks, 'sum', 'mean' and sin features, two GCLs a block, and every padded
hidden width of the tile (64, 128, 256, 512); the forward, the backward that
recomputes the forward, and the training route (the forward saving its
activations, the backward from them). Every output's sha256 is compared;
the script prints one JSON line and exits non-zero on any difference.

#1 and #2 share their tile machinery (``csrc/egnn_tile.cuh``) with the
row-tiled forward grid of #3/#4/#6, so a change there must leave their
arithmetic as it was. The row-tiled kernels (#3-#5) left this script when
their forward grid moved to split-TF32 column windows: their outputs now
differ from an older checkout's in the last bits, and they are held against
their plain versions instead (``tests/test_torch_port_cuda.py``,
``chip_smoke.py`` phases 9, 12 and 15); that #6 over every row equals #3 bit
for bit is a card test.
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


def _dump(root: str) -> dict:
    """sha256 of every output of #1 and #2 with ``root``'s package."""
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
