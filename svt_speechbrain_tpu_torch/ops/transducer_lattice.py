"""RNN-T (transducer) lattice and loss with a hand-written backward (port of
``svt_speechbrain_tpu/ops/transducer_lattice.py``).

Two CUDA kernels (``csrc/transducer_lattice.cu``), each with its plain
PyTorch version and a launch counter:

- ``rnnt_lattice`` (plain: ``lattice_plain``) fills

      out[t, u] = logaddexp(out[t-1, u] + a[t-1, u],
                            out[t, u-1] + b[t, u-1], seed[t, u])

  per batch row. It replaces the TPU kernel ``_run_lattice`` (``:67``, body
  ``_lattice_kernel``), which runs the same recurrence on skewed, lane-padded
  panels, one anti-diagonal a grid step. With ``reverse=True`` the kernel
  runs the recurrence from the far corner, which gives the beta lattice
  straight from the masked skip and emit panels: the flips, the shift and the
  padding rows of the JAX ``_beta`` are index arithmetic in the kernel (the
  plain version builds them with ``torch.flip``, as the JAX package does).
  Two routes, by U1 alone (``lattice_plan``): up to ``WARP_MAX_U1`` a
  block of warps a batch row holds the diagonal in registers, a cell a
  thread, while helper warps stage the panels ahead of the wavefront
  through a ring in shared memory and store the finished rows; wider
  lattices take the first port's design, the diagonal in shared memory.
  The kernel's source decides each route's threads and shared memory; the
  plan reads them from the library.
- ``rnnt_grad`` (plain: ``rnnt_grad_plain``) is the closed-form gradient of
  the loss w.r.t. the logits, ``_nll_logits_bwd`` (``:276``): the transition
  posteriors scattered to the blank and the target labels, fused with the
  log-softmax VJP, in one pass over (B, T, U+1, V) that reads the logits
  once and writes the gradient once.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs the plain version. The forward's ``logsumexp`` over V and the gather of
the skip and emit panels are PyTorch calls, as they are XLA in the JAX
package.

``NEG_INF`` is -1e30, finite, never ``-inf``: sums of two stay finite.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from svt_speechbrain_tpu_torch.ops import _build

NEG_INF = -1e30
SHARED_LIMIT = 232448        # bytes of shared memory a block may take
WARP_MAX_U1 = 128            # route A takes U1 up to this (`kWarpMaxU1`)
ROUTES = ("warp", "block")   # A, B; their codes in the C interface are 0, 1

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "svt_rnnt_lattice": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "svt_rnnt_lattice_block": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "svt_rnnt_lattice_plan": [_I, _I, ctypes.POINTER(_I)],
    "svt_rnnt_lattice_attributes": [_I, _I, ctypes.POINTER(_I)],
    "svt_rnnt_grad": [_P] * 10 + [_I] * 7 + [_P]}


def _check_f32(device, **tensors):
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(f"{name} must be a contiguous f32 tensor on "
                             f"{device}, got {t.dtype} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")


# ------------------------------------------------------------------ lattice
def lattice_plain(a, b, seed, reverse=False):
    """The plain version of ``rnnt_lattice``: a loop over anti-diagonals,
    each one vectorized over the batch and the label axis. -1e30-safe
    (``torch.logaddexp`` of finite values). Not differentiable: it writes
    its output in place.

    Example
    -------
    >>> import torch
    >>> a = torch.zeros(1, 2, 2); b = torch.zeros(1, 2, 2)
    >>> seed = torch.full((1, 2, 2), NEG_INF); seed[0, 0, 0] = 0.0
    >>> lattice_plain(a, b, seed)[0].exp()          # paths into each cell
    tensor([[1., 1.],
            [1., 2.]])
    """
    if reverse:
        # gamma[t', u'] = beta[T - t', U - u'] (the JAX ``_beta``, ``:173``)
        bsz, t, u1 = a.shape
        neg_row = a.new_full((bsz, 1, u1), NEG_INF)
        a_g = torch.cat([a.flip(1, 2), neg_row], dim=1)
        b_flip = torch.cat([b.flip(1, 2)[:, :, 1:],
                            a.new_full((bsz, t, 1), NEG_INF)], dim=2)
        b_g = torch.cat([neg_row, b_flip], dim=1)
        return lattice_plain(a_g, b_g, seed.flip(1, 2)).flip(1, 2)
    _, rows, u1 = seed.shape
    out = torch.empty_like(seed)
    out[:, 0, 0] = seed[:, 0, 0]
    neg = seed.new_full((), NEG_INF)
    for d in range(1, rows + u1 - 1):
        u = torch.arange(max(0, d - rows + 1), min(u1 - 1, d) + 1,
                         device=seed.device)
        t = d - u
        tp, up = (t - 1).clamp(min=0), (u - 1).clamp(min=0)
        stay = torch.where(t >= 1, out[:, tp, u] + a[:, tp, u], neg)
        move = torch.where(u >= 1, out[:, t, up] + b[:, t, up], neg)
        out[:, t, u] = torch.logaddexp(torch.logaddexp(stay, move),
                                       seed[:, t, u])
    return out


class LatticePlan(NamedTuple):
    """How ``csrc/transducer_lattice.cu`` runs one lattice: the route
    (``"warp"``, A: ``svt_rnnt_lattice``; ``"block"``, B:
    ``svt_rnnt_lattice_block``), threads and blocks of the grid, dynamic
    shared memory a block in bytes, and for route A the anti-diagonals its
    ring holds (0 for route B)."""
    route: str
    threads: int
    blocks: int
    smem: int
    ring: int


def _plan(route, batch, u1, lib):
    """The plan of ``route`` for U1 with the geometry the library's build
    gives (``svt_rnnt_lattice_plan``): the kernel's macros decide it, and
    the launch uses the same numbers."""
    lib = lib or _build.load("transducer_lattice", _SIGNATURES)
    out = (ctypes.c_int * 3)()
    _build.check(lib.svt_rnnt_lattice_plan(ROUTES.index(route), u1, out),
                 "rnnt_lattice plan")
    return LatticePlan(route, out[0], batch, out[1], out[2])


def _block_plan(batch, u1, lib=None):
    """Route B for any U1: a block a batch row, a thread a label position
    (at most 1024), two diagonals of f32 in shared memory."""
    return _plan("block", batch, u1, lib)


def lattice_plan(batch, rows, u1, reverse, lib=None):
    """The launch of one lattice. The route is decided by U1 alone
    (``rows`` and ``reverse`` change nothing: a ring covers the diagonal's
    U1 rows either way): up to ``WARP_MAX_U1``, route A, a block a batch
    row of ceil(U1 / 32) compute warps, a cell a thread, and helper warps
    that stage the panels through a ring of anti-diagonals and store the
    rows; wider, route B. Threads, shared memory and the ring come from
    ``lib`` (default: the built kernel), so a tuning build of other macros
    gets its own.

    Example
    -------
    >>> lattice_plan(8, 749, 81, False)             # doctest: +SKIP
    LatticePlan(route='warp', threads=224, blocks=8, smem=108288, ring=94)
    >>> lattice_plan(8, 749, 129, True).route       # doctest: +SKIP
    'block'
    """
    route = "warp" if u1 <= WARP_MAX_U1 else "block"
    return _plan(route, batch, u1, lib)


def lattice_kernel_attributes(lib=None, u1s=(32, 81, 128, 1500)):
    """What ptxas and the occupancy calculator made of each instantiation
    the lattice launches: for each U1 in ``u1s``, the route ``lattice_plan``
    gives it (and route B beside route A). Dicts with ``route``, ``u1``,
    ``registers`` (per thread), ``local_bytes`` (per thread: 0 means no
    spills), ``smem_bytes`` (dynamic, a block), ``threads`` and
    ``blocks_per_sm``."""
    lib = lib or _build.load("transducer_lattice", _SIGNATURES)
    rows = []
    for u1 in u1s:
        routes = ["block"]
        if lattice_plan(1, 2, u1, False, lib).route == "warp":
            routes.insert(0, "warp")
        for route in routes:
            out = (ctypes.c_int * 5)()
            _build.check(lib.svt_rnnt_lattice_attributes(
                ROUTES.index(route), u1, out), "rnnt_lattice attributes")
            rows.append(dict(route=route, u1=u1, registers=out[0],
                             local_bytes=out[1], smem_bytes=out[2],
                             threads=out[3], blocks_per_sm=out[4]))
    return rows


def _launch(a, b, seed, reverse, plan=None, lib=None):
    """One launch of the lattice kernel on CUDA panels already checked:
    ``(out, plan)``. ``plan`` (default ``lattice_plan``) may force route B
    where route A would run, to time the two in one process."""
    bsz, rows, u1 = seed.shape
    lib = lib or _build.load("transducer_lattice", _SIGNATURES)
    plan = plan or lattice_plan(bsz, rows, u1, reverse, lib)
    if plan.smem > SHARED_LIMIT:
        raise ValueError(f"U + 1 = {u1} is too long for the lattice kernel: "
                         f"two diagonals of f32 must fit in {SHARED_LIMIT} "
                         f"bytes of shared memory")
    out = torch.empty_like(seed)
    if out.numel() == 0:
        return out, plan
    launch = (lib.svt_rnnt_lattice if plan.route == "warp"
              else lib.svt_rnnt_lattice_block)
    err = launch(a.data_ptr(), b.data_ptr(), seed.data_ptr(), out.data_ptr(),
                 bsz, rows, u1, int(reverse), _build.stream_handle())
    _build.check(err, "rnnt_lattice kernel launch")
    rnnt_lattice.launches += 1
    return out, plan


def rnnt_lattice(a, b, seed, reverse=False):
    """The lattice ``out`` of the module docstring, per batch row, f32.

    Forward: ``a``, ``b``, ``seed`` and the result are (B, rows, U1).
    ``reverse=True``: ``a`` and ``b`` are (B, T, U1), ``seed`` and the
    result (B, T + 1, U1), and

        out[t, u] = logaddexp(out[t+1, u] + a[t, u], out[t, u+1] + b[t, u],
                              seed[t, u]).

    CUDA tensors: one kernel launch on the route of ``lattice_plan``
    (``rnnt_lattice.launches`` counts it), or an error for what the kernel
    does not take. CPU tensors: ``lattice_plain``."""
    _check_panels(a, b, seed, reverse)
    if seed.device.type == "cpu":
        return lattice_plain(a, b, seed, reverse)
    return _launch(a, b, seed, reverse)[0]


def _check_panels(a, b, seed, reverse):
    want = (seed.shape[0], seed.shape[1] - int(reverse), seed.shape[2])
    if seed.dim() != 3 or a.shape != want or b.shape != want:
        raise ValueError(f"panel shapes do not match: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, seed {tuple(seed.shape)}, "
                         f"reverse={reverse}")
    if seed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {seed.device}")
    if seed.device.type == "cuda":
        _check_f32(seed.device, a=a, b=b, seed=seed)


rnnt_lattice.launches = 0


# ----------------------------------------------------------------- gradient
def _gather_skip_emit(logits, lse, targets, blank_index):
    """``skip[t, u] = log p(blank | t, u)`` and ``emit[t, u] =
    log p(target[u] | t, u)`` (with a -1e30 last column, which has no
    emission), both (B, T, U1), from logits and their logsumexp without
    storing the log-probabilities (``_gather_skip_emit``, ``:238``)."""
    bsz, t_max, _, _ = logits.shape
    skip = logits[..., blank_index] - lse
    index = targets.long()[:, None, :, None].expand(bsz, t_max, -1, 1)
    emit = logits[:, :, :-1].gather(-1, index)[..., 0] - lse[:, :, :-1]
    emit_pad = torch.cat([emit, emit.new_full((bsz, t_max, 1), NEG_INF)],
                         dim=2)
    return skip, emit_pad


def _masks(t_len, u_len, t_max, u1):
    """(skip_mask, emit_mask, final_mask, seed_tu) of one batch
    (``:349-362``): where a row may skip and emit, the cell whose skip ends
    the lattice, and beta's seed on the (T + 1, U1) grid."""
    dev = t_len.device
    t_grid = torch.arange(t_max + 1, device=dev)[None, :, None]
    u_grid = torch.arange(u1, device=dev)[None, None, :]
    tl, ul = t_len[:, None, None], u_len[:, None, None]
    t_valid = t_grid[:, :-1] < tl
    skip_mask = t_valid & (u_grid <= ul)
    emit_mask = t_valid & (u_grid < ul)
    final_mask = (t_grid[:, :-1] == tl - 1) & (u_grid == ul)
    seed_tu = torch.where((t_grid == tl) & (u_grid == ul), 0.0, NEG_INF)
    return skip_mask, emit_mask, final_mask, seed_tu


def _masked_panels(logits, lse, targets, t_len, u_len, blank_index):
    """beta's inputs: the skip and emit panels at -1e30 outside each row's
    valid region, and the seed."""
    _, t_max, u1, _ = logits.shape
    skip, emit_pad = _gather_skip_emit(logits, lse, targets, blank_index)
    skip_mask, emit_mask, _, seed_tu = _masks(t_len, u_len, t_max, u1)
    neg = skip.new_full((), NEG_INF)
    return (torch.where(skip_mask, skip, neg),
            torch.where(emit_mask, emit_pad, neg), seed_tu)


def rnnt_grad_plain(logits, lse, targets, alpha, beta, log_z, t_len, u_len,
                    g, blank_index, from_log_probs=False):
    """The plain version of ``rnnt_grad`` (``_nll_logits_bwd``,
    ``:285-307``): the transition posteriors (Graves 2012, eq. 20) from
    alpha and beta, clipped to [-1e30, 0] before ``exp`` so that they are
    exactly 0 outside the valid region and never above 1; scattered (added:
    a target equal to the blank gets both terms) to the blank and target
    labels; then the log-softmax VJP in closed form."""
    bsz, t_max, u1, _ = logits.shape
    skip_m, emit_m, _ = _masked_panels(logits, lse, targets, t_len, u_len,
                                       blank_index)
    lz = log_z[:, None, None]
    occ_skip = torch.exp(torch.clamp(
        alpha + skip_m + beta[:, 1:, :] - lz, NEG_INF, 0.0))
    beta_u = torch.cat([beta[:, :-1, 1:],
                        beta.new_full((bsz, t_max, 1), NEG_INF)], dim=2)
    occ_emit = torch.exp(torch.clamp(alpha + emit_m + beta_u - lz,
                                     NEG_INF, 0.0))
    gb = g[:, None, None]
    d_lp = torch.zeros_like(logits)
    d_lp[..., blank_index] += -gb * occ_skip
    index = targets.long()[:, None, :, None].expand(bsz, t_max, -1, 1)
    d_lp[:, :, :-1].scatter_add_(-1, index,
                                 (-gb * occ_emit[:, :, :-1])[..., None])
    if from_log_probs:
        return d_lp
    total = -gb * (occ_skip + occ_emit)            # = sum_v d_lp[..., v]
    return d_lp - torch.exp(logits - lse[..., None]) * total[..., None]


def rnnt_grad(logits, lse, targets, alpha, beta, log_z, t_len, u_len, g,
              blank_index, from_log_probs=False):
    """d(sum_b g[b] * nll[b]) / d logits, (B, T, U1, V) f32.

    ``logits`` (B, T, U1, V) f32; ``lse`` (B, T, U1) their logsumexp over V
    (zeros, unread, with ``from_log_probs``); ``targets`` (B, U) int32;
    ``alpha`` (B, T, U1) and ``beta`` (B, T + 1, U1) the two lattices;
    ``log_z``, ``g`` (B,) f32; ``t_len``, ``u_len`` (B,) int32.

    CUDA tensors: one kernel launch (``rnnt_grad.launches`` counts it), or
    an error. CPU tensors: ``rnnt_grad_plain``."""
    bsz, t_max, u1, v = logits.shape
    for name, t, shape in (("lse", lse, (bsz, t_max, u1)),
                           ("targets", targets, (bsz, u1 - 1)),
                           ("alpha", alpha, (bsz, t_max, u1)),
                           ("beta", beta, (bsz, t_max + 1, u1)),
                           ("log_z", log_z, (bsz,)), ("g", g, (bsz,)),
                           ("t_len", t_len, (bsz,)), ("u_len", u_len, (bsz,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shape}")
    if not 0 <= blank_index < v:
        raise ValueError(f"blank_index {blank_index} outside [0, {v})")
    if logits.device.type == "cpu":
        return rnnt_grad_plain(logits, lse, targets, alpha, beta, log_z,
                               t_len, u_len, g, blank_index, from_log_probs)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    _check_f32(logits.device, logits=logits, lse=lse, alpha=alpha, beta=beta,
               log_z=log_z, g=g)
    for name, t in (("targets", targets), ("t_len", t_len), ("u_len", u_len)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != logits.device:
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{logits.device}")
    d_logits = torch.empty_like(logits)
    if d_logits.numel() == 0:
        return d_logits
    vec = v % 4 == 0 and logits.data_ptr() % 16 == 0 \
        and d_logits.data_ptr() % 16 == 0
    lib = _build.load("transducer_lattice", _SIGNATURES)
    err = lib.svt_rnnt_grad(
        logits.data_ptr(), lse.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
        log_z.data_ptr(), targets.data_ptr(), t_len.data_ptr(),
        u_len.data_ptr(), g.data_ptr(), d_logits.data_ptr(), bsz, t_max, u1,
        v, blank_index, int(from_log_probs), int(vec), _build.stream_handle())
    _build.check(err, "rnnt_grad kernel launch")
    rnnt_grad.launches += 1
    return d_logits


rnnt_grad.launches = 0


# --------------------------------------------------------------------- loss
class _NllLogits(torch.autograd.Function):
    """Per-row negative log-likelihood of the lattice from f32 logits, with
    the hand-written backward (``_nll_logits``, ``:248-313``). Saved for the
    backward: the logits themselves (no copy), their logsumexp, alpha and
    ``log_z``; beta is filled in the backward. ``plain`` takes the plain
    versions on any device."""

    @staticmethod
    def forward(ctx, logits, targets, t_len, u_len, blank_index,
                from_log_probs, plain):
        fill = lattice_plain if plain else rnnt_lattice
        bsz, t_max, u1, _ = logits.shape
        if from_log_probs:
            lse = logits.new_zeros(bsz, t_max, u1)
        else:
            lse = torch.logsumexp(logits, dim=-1)
        skip, emit_pad = _gather_skip_emit(logits, lse, targets, blank_index)
        # alpha runs over the whole grid unmasked: it flows forward, so
        # what lies past a row's lengths never reaches its valid region
        seed = torch.full_like(skip, NEG_INF)
        seed[:, 0, 0] = 0.0
        alpha = fill(skip, emit_pad, seed)
        final_mask = _masks(t_len, u_len, t_max, u1)[2]
        # log Z = alpha[T-1, U] + skip[T-1, U]
        log_z = torch.where(final_mask, alpha + skip,
                            torch.zeros_like(skip)).sum(dim=(1, 2))
        ctx.save_for_backward(logits, lse, targets, t_len, u_len, alpha,
                              log_z)
        ctx.config = (blank_index, from_log_probs, plain)
        return -log_z

    @staticmethod
    def backward(ctx, g):
        logits, lse, targets, t_len, u_len, alpha, log_z = ctx.saved_tensors
        blank_index, from_log_probs, plain = ctx.config
        fill = lattice_plain if plain else rnnt_lattice
        grad = rnnt_grad_plain if plain else rnnt_grad
        skip_m, emit_m, seed_tu = _masked_panels(logits, lse, targets, t_len,
                                                 u_len, blank_index)
        beta = fill(skip_m, emit_m, seed_tu, reverse=True)
        d_logits = grad(logits, lse, targets, alpha, beta, log_z, t_len,
                        u_len, g.float().contiguous(), blank_index,
                        from_log_probs)
        return d_logits, None, None, None, None, None, None


def transducer_loss_fused(logits, targets, input_lens, target_lens,
                          blank_index, reduction="mean",
                          from_log_probs=False, lattice="kernel"):
    """Drop-in replacement for ``nnet.loss.transducer_loss.transducer_loss``
    with the lattices filled by the ``rnnt_lattice`` kernel and a
    hand-written backward: the beta lattice plus the closed-form gradient
    w.r.t. the logits (``rnnt_grad``). Same API: (B, T, U+1, V) logits,
    (B, U) targets, relative lengths. The logits are cast to f32 on entry;
    a bf16 input gets a bf16 gradient back.

    ``lattice`` is ``"kernel"`` or ``"pallas"`` (the name the JAX package
    gives its hand-written kernel): both launch the CUDA kernels on CUDA
    tensors, or raise, and run the plain versions on CPU tensors. The JAX
    package's default, ``"scan"``, is an XLA program with no kernel in it;
    its counterpart here is the plain version, which ``lattice="scan"``
    selects on any device, for tests and comparisons only.

    ``reduction``: "mean" and "batchmean" give the mean over rows, "sum"
    their sum, anything else the rows.

    Example
    -------
    >>> import torch
    >>> from svt_speechbrain_tpu_torch.nnet.loss.transducer_loss import (
    ...     transducer_loss)
    >>> logits = torch.randn(2, 5, 4, 6,
    ...                      generator=torch.Generator().manual_seed(0))
    >>> targets = torch.tensor([[1, 2, 3], [2, 4, 0]])
    >>> t_len, u_len = torch.tensor([1.0, 0.8]), torch.tensor([1.0, 2 / 3])
    >>> fused = transducer_loss_fused(logits, targets, t_len, u_len,
    ...                               blank_index=0)
    >>> ref = transducer_loss(logits, targets, t_len, u_len, blank_index=0)
    >>> bool(torch.allclose(fused, ref, atol=1e-5))
    True
    """
    if lattice not in ("kernel", "pallas", "scan"):
        raise ValueError(f"lattice must be 'kernel', 'pallas' or 'scan', "
                         f"not {lattice!r}")
    logits = torch.as_tensor(logits)
    dev = logits.device
    bsz, t_max, u1, _ = logits.shape
    targets = torch.as_tensor(targets).to(dev, torch.int32).contiguous()
    if targets.shape != (bsz, u1 - 1):
        raise ValueError(f"targets {tuple(targets.shape)} do not match "
                         f"logits {tuple(logits.shape)}")
    t_len, u_len = (
        torch.round(torch.as_tensor(rel, dtype=torch.float32).to(dev) * n)
        .to(torch.int32) for rel, n in ((input_lens, t_max),
                                        (target_lens, u1 - 1)))
    nll = _NllLogits.apply(logits.float().contiguous(), targets, t_len, u_len,
                           blank_index, from_log_probs, lattice == "scan")
    if reduction in ("mean", "batchmean"):
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def transducer_loss_pallas(logits, targets, input_lens, target_lens,
                           blank_index, reduction="mean",
                           from_log_probs=False):
    """``transducer_loss_fused`` under the JAX package's name for the path
    through its hand-written lattice kernel (``lattice="pallas"``)."""
    return transducer_loss_fused(logits, targets, input_lens, target_lens,
                                 blank_index, reduction=reduction,
                                 from_log_probs=from_log_probs,
                                 lattice="pallas")
