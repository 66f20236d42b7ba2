"""One EGNN EquivariantBlock, forward and backward: the hand-written CUDA
kernels, their plain PyTorch versions and the autograd Function that joins
them.

- Forward: port of the TPU kernel ``geoldm_tpu/ops/pallas_egnn.py:_make_kernel``
  over ``_block_math`` (pallas_call at ``:447``), in ``csrc/egnn_block.cu``.
- Backward: port of ``_make_bwd_kernel`` (pallas_call at ``:507``), in
  ``csrc/egnn_block_bwd.cu``: dh, dx, the exact dx0 and every weight
  gradient summed over the batch.
- Both run their edge MLPs on multi-row tiles (``csrc/egnn_block_tile.cuh``)
  with the products on the tensor cores in split TF32 (3xTF32, f32
  accuracy); ``split_tf32_matmul`` emulates that rounding on the CPU.
- The bf16 variants (``compute_dtype=torch.bfloat16``: JAX's ``bfloat16``
  / ``bfloat16_pallas``, ``_matmul`` in ``_block_math``): the forward runs
  every product on bf16 operands with f32 accumulation
  (``egnn_block_forward_bf16``); its plain version is the module's forward
  with each matrix product's operands rounded to bf16
  (``nn.core.round_operand``: the product of two bf16 values is exact in
  f32). The backward (``egnn_block_backward_bf16``) is that forward's vjp:
  each product's cotangent stays f32 and the gradient it returns to a bf16
  operand is rounded to bf16, as ``jax.vjp`` of ``_block_math`` and
  autograd through ``round_operand`` both round it; its plain version is
  ``torch.autograd.grad`` of the plain bf16 forward. The ops take the
  operand dtype alone (None or ``torch.bfloat16``); a compute-dtype name is
  resolved above them (``nn.core``).
- ``EquivariantBlockFunction`` runs the forward kernel, which on the card
  also saves each GCL's h, aggregate, node-MLP pre-activation and its silu
  ([B*N, H] each), and the backward kernel from those (as ``_fwd``/``_bwd``
  of ``fused_block_apply`` do with ``bwd_mode='pallas'``).
  ``block_backward_cuda`` alone recomputes them with the forward's own code,
  so both routes give the same bits.
- The low-precision variants (``compute_dtype=nn.core.BF16_EDGE_LOWP``:
  JAX's ``bfloat16_pallas`` under GEOLDM_PALLAS_EDGE_LOWP=1, ``edge_dtype``
  bf16 in ``_block_math``, ``pallas_egnn.py:160-228``): the bf16 variants
  with the edge chain in bf16 as well, rounded where JAX's rounds it (the
  pre-activation, each sigmoid, each bf16 product and sum of the silu and
  the gate, the W2 and gate products' outputs, b2 and the gate's bias).
  Forward ``egnn_block_forward_lowp`` (``csrc/egnn_block_lowp.cu``),
  backward ``egnn_block_backward_lowp`` (``csrc/egnn_block_bwd_lowp.cu``),
  each the vjp site by site of the other, as autograd through the plain
  version (the modules' forward with ``BF16_EDGE_LOWP``) returns it. They
  run only where JAX would keep the molecule whole (``whole_molecule``);
  elsewhere the operand is ``torch.bfloat16``.

``block_forward`` is what the EGNN calls. It routes by the padded node
count N, from this card's limits:

- N <= ``MAX_NODES`` (64): the whole-molecule kernels above. A CTA owns
  whole rows of one molecule, R = 64 // N of them, as one tile of at most 64
  edge rows (``csrc/egnn_block_tile.cuh:kTileRows``), so a row longer than
  64 columns does not fit. On the card it goes through the Function while
  grad is enabled and is the bare forward kernel under ``no_grad`` (which
  saves nothing); on the CPU it runs the plain version.
- N > 64: the row-tiled kernels of ``ops.egnn_tiled`` (TPU kernels #3 and
  #4 forward, #5 backward; columns streamed in tiles), on the card and on
  the CPU alike (their plain versions there). While grad is enabled the
  block goes through ``egnn_tiled.TiledEquivariantBlockFunction``, under
  ``no_grad`` it is the bare forward.

(The TPU package's routing, ``pallas_egnn.dispatch_to_tiled``, follows VMEM
budgets of the TPU and is not this rule; its copy here, ``dispatch_to_tiled``,
decides only where the edge chain runs in bf16.) A wrapper given a CUDA tensor
launches its kernel or raises; only CPU tensors take a plain version. The
kernels are built by ``ops.cuda_build``.

``launches`` / ``bwd_launches`` / ``bf16_launches`` / ``bwd_bf16_launches``
/ ``lowp_launches`` / ``bwd_lowp_launches`` count kernel calls: one per
block forward / backward / bf16 forward / bf16 backward / low-precision
forward / low-precision backward on the card.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from geoldm_tpu_torch.nn.core import BF16_EDGE_LOWP
from geoldm_tpu_torch.ops import cuda_build
from geoldm_tpu_torch.ops.distance import build_edge_mask, coord2diff, sin_embedding

launches = 0
bwd_launches = 0
bf16_launches = 0
bwd_bf16_launches = 0
lowp_launches = 0
bwd_lowp_launches = 0

MAX_NODES = 64  # csrc/egnn_common.cuh:kMaxNodes: one row's edges fit one 64-row tile
MAX_HIDDEN = 512  # csrc/egnn_common.cuh:kMaxHidden, the widest tile (512 threads)


def _block_weight_names(block) -> tuple:
    """(per-GCL name lists, coordinate name list) of an
    ``nn.egnn.EquivariantBlock`` in the kernels' pointer order; ``None``
    holds the attention slots of a block without attention."""
    gcls = []
    for j in range(block.cfg.inv_sublayers):
        g = f"gcl_{j}."
        att = [g + "att_mlp.0.weight", g + "att_mlp.0.bias"] if block.cfg.attention else [None] * 2
        gcls.append([g + "edge_mlp.0.weight", g + "edge_mlp.0.bias", g + "edge_mlp.2.weight",
                     g + "edge_mlp.2.bias", *att, g + "node_mlp.0.weight", g + "node_mlp.0.bias",
                     g + "node_mlp.2.weight", g + "node_mlp.2.bias"])
    coord = [f"gcl_equiv.coord_mlp.{k}" for k in
             ("0.weight", "0.bias", "2.weight", "2.bias", "4.weight")]
    return gcls, coord


def block_param_names(block) -> list:
    """Names of the block's weights in the order the Function takes them."""
    gcls, coord = _block_weight_names(block)
    return [n for ns in gcls + [coord] for n in ns if n is not None]


def block_params(block) -> list:
    """The block's weights, in ``block_param_names`` order."""
    params = dict(block.named_parameters())
    return [params[n] for n in block_param_names(block)]


def _pointer_table(names, tensors: dict):
    return (ctypes.c_void_p * len(names))(
        *[tensors[n].data_ptr() if n is not None else None for n in names])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"egnn_block: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"egnn_block: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"egnn_block: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"egnn_block: {name} must be contiguous")


def _validate(block, h, x, x0, node_mask, **grads) -> dict:
    """What both kernels refuse; returns the block's weights by name."""
    cfg = block.cfg
    b, n, hidden = h.shape
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"egnn_block kernels need CUDA tensors, got {dev}")
    if n > MAX_NODES:
        raise ValueError(
            f"egnn_block kernel holds at most {MAX_NODES} nodes per molecule "
            f"(one row's edges in one 64-row tile); got N={n}")
    if hidden % 32 or not 32 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"egnn_block kernel needs hidden_nf a multiple of 32 in "
                         f"[32, {MAX_HIDDEN}]; got {hidden}")
    if hidden != cfg.hidden_nf:
        raise ValueError(f"h has {hidden} features, block expects {cfg.hidden_nf}")
    shapes = {"h": (b, n, hidden), "x": (b, n, 3), "x0": (b, n, 3), "node_mask": (b, n, 1),
              "dh_out": (b, n, hidden), "dx_out": (b, n, 3)}
    for name, t in dict(h=h, x=x, x0=x0, node_mask=node_mask, **grads).items():
        _check(name, t, shapes[name], dev)
    params = dict(block.named_parameters())
    weights = {name: params[name] for name in block_param_names(block)}
    for name, w in weights.items():
        _check(name, w, w.shape, dev)
    w1 = weights["gcl_0.edge_mlp.0.weight"]
    if w1.shape != (hidden, 2 * hidden + cfg.edge_feat_nf):
        raise ValueError(f"edge_mlp.0.weight has shape {tuple(w1.shape)}, "
                         f"expected {(hidden, 2 * hidden + cfg.edge_feat_nf)}")
    return weights


def _cfg_args(cfg):
    return (cfg.inv_sublayers, int(cfg.attention), int(cfg.sin_embedding), int(cfg.tanh),
            int(cfg.aggregation_method == "mean"), float(cfg.coords_range_layer),
            float(cfg.norm_constant), float(cfg.normalization_factor))


def bf16_variant(compute_dtype, what: str) -> bool:
    """Whether ``compute_dtype`` (None, ``torch.bfloat16`` or
    ``BF16_EDGE_LOWP``) selects a wrapper's bf16 (or low-precision)
    variant; anything else (a compute-dtype name among them) raises
    TypeError."""
    if compute_dtype is None:
        return False
    if compute_dtype is not BF16_EDGE_LOWP and compute_dtype != torch.bfloat16:
        raise TypeError(f"{what}: compute dtype {compute_dtype!r}; the kernels take None, "
                        "torch.bfloat16 or nn.core.BF16_EDGE_LOWP (resolve a name with "
                        "nn.core.resolve_compute)")
    return True


# JAX's routing of its Pallas EGNN (pallas_egnn.py:58-65, 344-352, 568-597)
# at its default bwd_mode 'pallas', kept here only to decide where the edge
# chain runs in bf16: its integer arithmetic, with the raised scoped-VMEM
# limit of geoldm_tpu/utils/tpuflags.py:27.
_RAISED_SCOPED_VMEM_KIB = 65536


def _edge_itemsize(compute_dtype) -> int:
    """Bytes of an edge activation in JAX's budget: 2 with the edge chain in
    bf16, else 4."""
    return 2 if compute_dtype is BF16_EDGE_LOWP else 4


def _bwd_rows_budget(n: int, hidden: int) -> int:
    """The pair rows JAX's fused whole-molecule backward may hold."""
    max_rows = max(256, int(_RAISED_SCOPED_VMEM_KIB * 0.95) * 1024 // (17 * 1024))
    if hidden > 256:
        max_rows = max_rows * 256 // hidden
    if n % 8 != 0:
        max_rows //= 2
    return max_rows


def dispatch_to_tiled(n: int, hidden_nf: int, compute_dtype=None) -> bool:
    """JAX's ``dispatch_to_tiled(n, hidden_nf, compute_dtype, 'pallas')``,
    with ``BF16_EDGE_LOWP`` standing for a bf16 compute dtype under the
    switch: True where JAX routes a molecule of n nodes to its row-tiled
    kernels (#3-#5)."""
    padded_n = -(-n // 8) * 8
    fwd_rows = 4096 * 4 // _edge_itemsize(compute_dtype)
    if n % 8 != 0:
        fwd_rows //= 2
    return (padded_n * padded_n > fwd_rows
            or padded_n * padded_n > _bwd_rows_budget(n, hidden_nf))


def whole_molecule(n: int, hidden_nf: int) -> bool:
    """Whether a block of n (padded) nodes runs its edge chain in bf16 under
    ``BF16_EDGE_LOWP``: the port's whole-molecule kernels take it (n <=
    MAX_NODES) and JAX keeps it whole with the switch on (QM9's n <= 29;
    of GEOM's pads 32 and 48, not 64)."""
    return n <= MAX_NODES and not dispatch_to_tiled(n, hidden_nf, BF16_EDGE_LOWP)


def block_operand(n: int, hidden_nf: int, compute_dtype):
    """The operand a block of n nodes runs: ``BF16_EDGE_LOWP`` only where
    ``whole_molecule``, else ``torch.bfloat16`` in its place."""
    if compute_dtype is BF16_EDGE_LOWP and not whole_molecule(n, hidden_nf):
        return torch.bfloat16
    return compute_dtype


def _forward_launch(block, h, x, x0, node_mask, save: bool, bf16: bool = False,
                    lowp: bool = False):
    """The forward kernel -> (h_out, x_out, saved): saved is the
    [4, inv_sublayers, B*N, H] stack of each GCL's output h, aggregate,
    node-MLP pre-activation and its silu for the backward, or None. bf16:
    the bf16 variant (its saved stack is the bf16 backward's); lowp (with
    bf16): the low-precision variant (its stack the low-precision
    backward's)."""
    global launches, bf16_launches, lowp_launches
    weights = _validate(block, h, x, x0, node_mask)
    b, n, hidden = h.shape
    dev = h.device
    lib = cuda_build.library("egnn_block_lowp" if lowp else "egnn_block")
    h_out = torch.empty_like(h)
    x_out = torch.empty_like(x)
    proj = torch.empty((b * n, 2 * hidden), device=dev, dtype=torch.float32)
    if save:
        saved = torch.empty((4, block.cfg.inv_sublayers, b * n, hidden), device=dev,
                            dtype=torch.float32)
        agg = tmp = None
    else:
        saved = None
        agg = torch.empty((b * n, hidden), device=dev, dtype=torch.float32)
        tmp = torch.empty((b * n, hidden), device=dev, dtype=torch.float32)
    gcl_names, coord_names = _block_weight_names(block)
    # bf16: (inv_sublayers + 1) W2s in bf16, converted by the kernel's call.
    w2bf = (torch.empty((block.cfg.inv_sublayers + 1, hidden, hidden), device=dev,
                        dtype=torch.bfloat16),) if bf16 else ()
    fn = (lib.egnn_block_forward_lowp if lowp else
          lib.egnn_block_forward_bf16 if bf16 else lib.egnn_block_forward)
    what = " low-precision" if lowp else " bf16" if bf16 else ""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            h.data_ptr(), x.data_ptr(), x0.data_ptr(), node_mask.data_ptr(),
            h_out.data_ptr(), x_out.data_ptr(), proj.data_ptr(), _ptr(agg), _ptr(tmp),
            _ptr(saved), *[t.data_ptr() for t in w2bf],
            _pointer_table(sum(gcl_names, []), weights), _pointer_table(coord_names, weights),
            b, n, hidden, block.cfg.edge_feat_nf, *_cfg_args(block.cfg), stream)
    if rc != 0:
        raise RuntimeError(f"egnn_block{what} kernel launch failed: "
                           f"{lib.egnn_block_error_string(rc).decode()} (cudaError {rc})")
    if lowp:
        lowp_launches += 1
    elif bf16:
        bf16_launches += 1
    else:
        launches += 1
    return h_out, x_out, saved


def block_forward_cuda(block, h, x, x0, node_mask, compute_dtype=None):
    """The forward kernel, or its bf16 variant for a bf16 ``compute_dtype``
    (its low-precision one for ``BF16_EDGE_LOWP``). h [B,N,H], x/x0
    [B,N,3], node_mask [B,N,1] on one card -> (h_out [B,N,H], x_out
    [B,N,3]); no ``grad_fn`` (``EquivariantBlockFunction`` gives one)."""
    bf16 = bf16_variant(compute_dtype, "egnn_block")
    h_out, x_out, _ = _forward_launch(block, h, x, x0, node_mask, save=False, bf16=bf16,
                                      lowp=compute_dtype is BF16_EDGE_LOWP)
    return h_out, x_out


def _backward_launch(block, h, x, x0, node_mask, dh_out, dx_out, saved, bf16: bool = False,
                     lowp: bool = False):
    """The backward kernel, from the forward's ``saved`` activations or,
    with None, recomputing them. bf16: the bf16 variant, from the bf16
    forward's saved stack; lowp (with bf16): the low-precision variant, from
    the low-precision forward's."""
    global bwd_launches, bwd_bf16_launches, bwd_lowp_launches
    dh_out, dx_out = dh_out.contiguous(), dx_out.contiguous()
    weights = _validate(block, h, x, x0, node_mask, dh_out=dh_out, dx_out=dx_out)
    b, n, hidden = h.shape
    dev = h.device
    cfg = block.cfg
    if saved is not None:
        _check("saved", saved, (4, cfg.inv_sublayers, b * n, hidden), dev)
    lib = cuda_build.library("egnn_block_bwd")
    grads = {name: torch.empty_like(w) for name, w in weights.items()}
    dh, dx, dx0 = torch.empty_like(h), torch.empty_like(x), torch.empty_like(x0)
    scratch = torch.empty(  # the low-precision variant's layout is the bf16 one's
        lib.egnn_block_backward_scratch_floats(b, n, hidden, cfg.edge_feat_nf, cfg.inv_sublayers,
                                               int(saved is None), int(bf16)),
        device=dev, dtype=torch.float32)
    gcl_names, coord_names = _block_weight_names(block)
    flat_gcl = sum(gcl_names, [])
    if lowp:
        lib = cuda_build.library("egnn_block_bwd_lowp")
    fn = (lib.egnn_block_backward_lowp if lowp else
          lib.egnn_block_backward_bf16 if bf16 else lib.egnn_block_backward)
    what = " low-precision" if lowp else " bf16" if bf16 else ""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            h.data_ptr(), x.data_ptr(), x0.data_ptr(), node_mask.data_ptr(),
            dh_out.data_ptr(), dx_out.data_ptr(), dh.data_ptr(), dx.data_ptr(), dx0.data_ptr(),
            _pointer_table(flat_gcl, weights), _pointer_table(coord_names, weights),
            _pointer_table(flat_gcl, grads), _pointer_table(coord_names, grads),
            _ptr(saved), scratch.data_ptr(), b, n, hidden,
            cfg.edge_feat_nf, *_cfg_args(cfg), stream)
    if rc != 0:
        raise RuntimeError(f"egnn_block{what} backward kernel launch failed: "
                           f"{lib.egnn_block_bwd_error_string(rc).decode()} (cudaError {rc})")
    if lowp:
        bwd_lowp_launches += 1
    elif bf16:
        bwd_bf16_launches += 1
    else:
        bwd_launches += 1
    return dh, dx, dx0, [grads[name] for name in block_param_names(block)]


def block_backward_cuda(block, h, x, x0, node_mask, dh_out, dx_out, compute_dtype=None):
    """The backward kernel, or its bf16 variant for a bf16
    ``compute_dtype`` (its low-precision one for ``BF16_EDGE_LOWP``):
    cotangents dh_out [B,N,H], dx_out [B,N,3] of the block outputs -> (dh,
    dx, dx0, [weight gradients in ``block_params`` order]), the weight
    gradients summed over the batch. Recomputes the forward's activations
    (the Function passes the saved ones instead)."""
    bf16 = bf16_variant(compute_dtype, "egnn_block backward")
    return _backward_launch(block, h, x, x0, node_mask, dh_out, dx_out, None, bf16,
                            compute_dtype is BF16_EDGE_LOWP)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds on the card."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 as the kernels' tensor-core products compute it
    (``csrc/egnn_block_tile.cuh``): each operand split into hi = tf32(v) and
    lo = tf32(v - hi), then lo_a hi_b + hi_a lo_b + hi_a hi_b, each product
    exact and the sums in float32. Plain emulation for the CPU tests."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def wgrad_splits(edges: int, hidden: int) -> tuple:
    """(splits, edge rows per split) of the W2-gradient GEMM over ``edges``
    edge rows at width ``hidden`` (``csrc/egnn_tc_gemm.cuh:wgrad_splits``):
    about two CTAs an SM over the [H, H] output tiles, at most 64 splits,
    but never more than 2048 edge rows in a split; the split a multiple of
    16 rows. Plain emulation for the CPU tests."""
    tiles = (-(-hidden // 128)) ** 2
    splits = max(min(256 // tiles, 64), 1, -(-edges // 2048))
    chunk = -(-(-(-edges // splits)) // 16) * 16
    return -(-edges // chunk), chunk


# The node GEMM's plan (csrc/egnn_tc_gemm.cuh): CTA tile, K chunk, the K
# rows a split sums at most (two chunks), the H100's SMs.
NODE_GEMM_TILE, NODE_GEMM_KC, NODE_GEMM_MAX_ROWS, NODE_GEMM_SMS = (64, 64), 64, 128, 132


def node_gemm_plan(m: int, n: int, k: int, problems: int = 1, cap: int = 0,
                   may_split: bool = True) -> tuple:
    """(tile rows, tile columns, K splits, K rows a split sums) of the node
    GEMM (``csrc/egnn_tc_gemm.cuh:node_gemm_plan``) for ``problems``
    products of ``m`` x ``n`` over ``k`` with a split buffer of ``cap``
    floats: K is split only where ``may_split`` and the output tiles fill at
    most half the card, into splits of 128 rows, or fewer and longer ones
    where the buffer holds fewer; a split a multiple of the 64-row chunk.
    Plain emulation for the CPU tests."""
    tm, tn = NODE_GEMM_TILE
    tiles = -(-m // tm) * -(-n // tn) * problems
    splits = 1
    if may_split and 2 * tiles <= NODE_GEMM_SMS and k > NODE_GEMM_MAX_ROWS:
        splits = -(-k // NODE_GEMM_MAX_ROWS)
        fit = cap // (problems * m * n)
        if splits > fit:
            splits = max(fit, 1)
    chunk = max(-(-(-(-k // splits)) // NODE_GEMM_KC) * NODE_GEMM_KC, NODE_GEMM_KC)
    return tm, tn, -(-k // chunk), chunk


def block_forward_plain(block, h, x, x0, node_mask, weights=None, compute_dtype=None):
    """Plain PyTorch version of the forward kernel: the module's own forward
    with the edge mask and initial distance features derived as the kernel
    derives them (``pallas_egnn.py:_reference_block``). ``weights`` (in
    ``block_params`` order) replace the module's parameters when given. A
    bf16 ``compute_dtype``: the bf16 variant's (each product's operands
    rounded to bf16)."""
    radial0, _ = coord2diff(x0)
    e0 = sin_embedding(radial0) if block.cfg.sin_embedding else radial0
    args = (h, x, e0, node_mask, build_edge_mask(node_mask))
    kwargs = {"compute_dtype": compute_dtype}
    if weights is None:
        return block(*args, **kwargs)
    return torch.func.functional_call(block, dict(zip(block_param_names(block), weights)), args,
                                      kwargs)


def block_backward_plain(block, h, x, x0, node_mask, dh_out, dx_out, weights=None,
                         compute_dtype=None):
    """Plain PyTorch version of the backward kernel: ``torch.autograd.grad``
    of the recomputed ``block_forward_plain``, as the Pallas kernel
    ``jax.vjp``s ``_block_math``. -> (dh, dx, dx0, [weight gradients]). A
    bf16 ``compute_dtype``: the bf16 variant's, autograd through the plain
    bf16 forward (each product's operand gradients rounded to bf16 where
    ``round_operand`` rounded the operands); ``BF16_EDGE_LOWP``: the
    low-precision variant's, autograd through the bf16 edge chain (each bf16
    value's cotangent rounded to bf16, as ``jax.vjp`` of ``_block_math``
    returns it)."""
    weights = block_params(block) if weights is None else weights
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (h, x, x0)]
        ws = [w.detach().requires_grad_() for w in weights]
        outs = block_forward_plain(block, *inputs, node_mask, ws, compute_dtype)
        grads = torch.autograd.grad(outs, inputs + ws, (dh_out, dx_out), allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(inputs + ws, grads)]
    return grads[0], grads[1], grads[2], grads[3:]


def _function_forward(ctx, compute_dtype, block, h, x, x0, node_mask, weights):
    bf16 = bf16_variant(compute_dtype, "egnn_block")
    if h.is_cuda:
        h_out, x_out, saved = _forward_launch(block, h, x, x0, node_mask, save=True, bf16=bf16,
                                              lowp=compute_dtype is BF16_EDGE_LOWP)
    else:
        h_out, x_out = block_forward_plain(block, h, x, x0, node_mask, weights, compute_dtype)
        saved = None
    ctx.block, ctx.compute_dtype = block, compute_dtype
    ctx.save_for_backward(h, x, x0, node_mask, saved, *weights)
    return h_out, x_out


class EquivariantBlockFunction(torch.autograd.Function):
    """One block with the kernels as forward and backward:
    ``apply(block, compute_dtype, h, x, x0, node_mask, *block_params(block))``.
    Saves the block inputs, the weights and, on the card, the forward
    kernel's activations (4 * inv_sublayers * B*N*H floats), so the backward
    kernel does not recompute the forward. On CPU tensors it runs the plain
    versions (for tests), which save no activations. ``compute_dtype``
    torch.bfloat16 runs the bf16 variants: the bf16 forward kernel saving
    its chain, then the bf16 backward kernel (on the CPU the plain bf16
    versions). ``BF16_EDGE_LOWP`` runs the low-precision variants likewise.
    """

    @staticmethod
    def forward(ctx, block, compute_dtype, h, x, x0, node_mask, *weights):
        return _function_forward(ctx, compute_dtype, block, h, x, x0, node_mask, weights)

    @staticmethod
    @once_differentiable
    def backward(ctx, dh_out, dx_out):
        h, x, x0, node_mask, saved, *weights = ctx.saved_tensors
        dtype = ctx.compute_dtype
        if h.is_cuda:
            dh, dx, dx0, dws = _backward_launch(ctx.block, h, x, x0, node_mask, dh_out, dx_out,
                                                saved, dtype is not None,
                                                dtype is BF16_EDGE_LOWP)
        else:
            dh, dx, dx0, dws = block_backward_plain(ctx.block, h, x, x0, node_mask, dh_out,
                                                    dx_out, weights, dtype)
        return (None, None, dh, dx, dx0, None, *dws)


def block_forward(block, h, x, x0, node_mask, compute_dtype=None):
    """The kernels for tensors on the card (through the autograd Function
    while grad is enabled), the plain version for tensors on the CPU;
    N > ``MAX_NODES`` goes to the row-tiled kernels (module docstring).
    ``compute_dtype`` torch.bfloat16 selects the bf16 variants, forward and
    backward; ``BF16_EDGE_LOWP`` the low-precision ones where
    ``whole_molecule``, the bf16 ones elsewhere."""
    train = torch.is_grad_enabled()
    bf16_variant(compute_dtype, "egnn_block")  # a compute name raises here
    compute_dtype = block_operand(h.shape[1], h.shape[2], compute_dtype)
    if h.shape[1] > MAX_NODES:
        from geoldm_tpu_torch.ops import egnn_tiled

        if train:
            return egnn_tiled.TiledEquivariantBlockFunction.apply(
                block, compute_dtype, h, x, x0, node_mask, *block_params(block))
        return egnn_tiled.tiled_block_forward(block, h, x, x0, node_mask, compute_dtype)
    if h.is_cuda:
        if train:
            return EquivariantBlockFunction.apply(block, compute_dtype, h, x, x0, node_mask,
                                                  *block_params(block))
        return block_forward_cuda(block, h, x, x0, node_mask, compute_dtype)
    if h.device.type == "cpu":
        return block_forward_plain(block, h, x, x0, node_mask, compute_dtype=compute_dtype)
    raise ValueError(f"egnn_block: unsupported device {h.device}")
