"""The RNN-T lattice kernel's launch plan and route A's schedule, on the CPU.

The kernel (``csrc/transducer_lattice.cu``) runs only on the card. What it
rests on is checked here: the wrapper's plan, through a stand-in for the
ctypes library (the route by U1 alone, threads, blocks, shared memory, the
ring's diagonals, all read from the library), and route A's schedule
emulated in torch (a label position a lane, the neighbour shuffled up from
the lane below, the anti-diagonal ring staged an epoch ahead with its slot
arithmetic in both directions, copies landing as early or as late as the
barriers allow, the guarded seed shortcut), bit for bit against
``lattice_plain``; and the identity behind the shortcut, in torch and in the
kernel's ``fmax + log1p(exp(-|d|))`` form.

The stand-in computes route A's geometry as the source's note states it,
with the epoch and the helper warps of the source's own defaults.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from svt_speechbrain_tpu_torch.ops import transducer_lattice as tl

L = tl.WARP_MAX_U1
U1S = [1, 5, 32, 33, 81, L, L + 1, 1500]
SOURCE = (Path(tl.__file__).resolve().parents[1] / "csrc"
          / "transducer_lattice.cu").read_text()


def _constant(pattern):
    return int(re.search(pattern, SOURCE).group(1))


# the shipped build's steps an epoch and helper warps
EPOCH = _constant(r"#define SVT_LAT_EPOCH (\d+)")
HELPERS = _constant(r"#define SVT_LAT_HELPERS (\d+)")


class _Lib:
    """Stands in for the ctypes library: records each launch, and gives
    each route's geometry (``svt_rnnt_lattice_plan``) for a build of
    ``epoch`` steps an epoch and ``helpers`` helper warps."""

    def __init__(self, epoch=EPOCH, helpers=HELPERS):
        self.calls = []
        self.epoch, self.helpers = epoch, helpers

    def svt_rnnt_lattice_plan(self, route, u1, out):
        if route == 1:                  # route B: two diagonals
            out[0], out[1], out[2] = min(1024, -(-u1 // 32) * 32), 8 * u1, 0
            return 0
        if not 0 < u1 <= L:
            return 1                    # cudaErrorInvalidValue
        warps = -(-u1 // 32)
        ring = u1 + 3 * self.epoch + 1
        out[0] = 32 * (warps + self.helpers)
        out[1] = 3 * 4 * ring * 32 * warps
        out[2] = ring
        return 0

    def svt_rnnt_lattice(self, *args):
        self.calls.append(("svt_rnnt_lattice", args))
        return 0

    def svt_rnnt_lattice_block(self, *args):
        self.calls.append(("svt_rnnt_lattice_block", args))
        return 0


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(tl._build, "stream_handle", lambda: None)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("u1", U1S)
def test_lattice_plan_route_by_u1(no_card, u1, reverse):
    bsz, rows = 3, 7
    seed = torch.zeros(bsz, rows, u1)
    a = b = torch.zeros(bsz, rows - int(reverse), u1)
    lib = _Lib()
    before = tl.rnnt_lattice.launches
    out, plan = tl._launch(a, b, seed, reverse, lib=lib)
    assert tl.rnnt_lattice.launches == before + 1
    assert plan == tl.lattice_plan(bsz, rows, u1, reverse, lib)
    # the route is U1's alone: another batch, rows or direction agree
    assert plan.route == tl.lattice_plan(64, 2, u1, not reverse, lib).route
    ((name, args),) = lib.calls
    assert args[:8] == (a.data_ptr(), b.data_ptr(), seed.data_ptr(),
                        out.data_ptr(), bsz, rows, u1, int(reverse))
    assert plan.blocks == bsz and plan.smem <= tl.SHARED_LIMIT
    if u1 <= L:
        # route A: the fewest warps of a cell a thread that cover U1,
        # HELPERS warps to stage and store, a ring of U1 + 3 EPOCH + 1
        # diagonals of (compute threads) floats a panel
        assert name == "svt_rnnt_lattice" and plan.route == "warp"
        compute = plan.threads - 32 * HELPERS
        assert compute % 32 == 0 and compute - 32 < u1 <= compute
        assert plan.ring == u1 + 3 * EPOCH + 1
        assert plan.smem == 3 * 4 * plan.ring * compute
    else:
        # route B: a block a batch row, a thread a label position
        assert name == "svt_rnnt_lattice_block" and plan.route == "block"
        assert plan.threads == min(1024, -(-u1 // 32) * 32)
        assert plan.smem == 8 * u1 and plan.ring == 0


def test_widest_warp_ring_fits_and_one_more_warp_does_not():
    """Route A stops at the widest U1 whose ring fits in a block's shared
    memory: one compute warp more would not fit."""
    plan = tl.lattice_plan(1, 2, L, False, _Lib())
    assert plan.smem <= tl.SHARED_LIMIT
    wider = L + 32
    assert 3 * 4 * (wider + 3 * EPOCH + 1) * wider > tl.SHARED_LIMIT


def test_route_limit_is_the_kernels():
    """The wrapper's route threshold is the one the kernel refuses above
    (``kWarpMaxU1``), and the stand-in's epoch and helpers are the
    source's defaults."""
    assert _constant(r"constexpr int kWarpMaxU1 = (\d+);") == L
    assert EPOCH >= 1 and HELPERS >= 1


@pytest.mark.parametrize("epoch,helpers", [(EPOCH, HELPERS), (2, 2), (6, 3)])
def test_plan_is_the_builds(epoch, helpers):
    """Threads, shared memory and the ring come from the library: a build
    of other macros (a tuning variant) gets its own, the route stays
    U1's."""
    lib = _Lib(epoch, helpers)
    plan = tl.lattice_plan(4, 749, 81, False, lib)
    assert plan == tl.LatticePlan("warp", 32 * (3 + helpers), 4,
                                  12 * (82 + 3 * epoch) * 96, 82 + 3 * epoch)
    assert tl.lattice_plan(4, 749, L + 1, True, lib).route == "block"
    assert tl._block_plan(4, 81, lib) == tl.LatticePlan("block", 96, 4,
                                                        648, 0)


def test_forced_block_route(no_card):
    """``plan=`` runs route B where route A would (to time the two in one
    process); the launch is counted all the same."""
    seed = torch.zeros(2, 9, 81)
    lib = _Lib()
    before = tl.rnnt_lattice.launches
    _, plan = tl._launch(seed, seed, seed, False,
                         plan=tl._block_plan(2, 81, lib), lib=lib)
    assert plan.route == "block"
    assert lib.calls[0][0] == "svt_rnnt_lattice_block"
    assert tl.rnnt_lattice.launches == before + 1


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("u1", [1, 5, 33, 81, L])
def test_ring_holds_every_live_diagonal(u1, reverse):
    """In epoch e (steps e R .. e R + R - 1, R = EPOCH) the compute warps
    read diagonals up to (e + 1) R, whose rows the staging warp put by the
    end of epoch e - 1, and write diagonals e R .. (e + 1) R - 1; the
    staging warp puts rows (e + 1) R + 1 .. (e + 2) R, on diagonals that
    keep their own slots of the ring, over the cells of rows the storing
    warp stored by the end of epoch e - 1 (rows up to (e - 1) R - U1): the
    U1 rows the wavefront spans plus the epochs ahead and behind (the same
    in both directions: reverse flips the rows as it stages them)."""
    plan = tl.lattice_plan(1, 50, u1, reverse, _Lib())
    r = EPOCH
    for e in range(3 * (u1 + r)):
        put = range((e + 1) * r + 1, (e + 2) * r + 1)
        touched = range(e * r, (e + 2) * r + u1 - 1)
        assert len({d % plan.ring for d in touched}) == len(touched)
        assert max(put) - plan.ring <= (e - 1) * r - u1


# ----------------------------------------------------- route A, emulated
def seed_is_low(s):
    """The kernel's vote: a finite seed at or below -1e30 takes the
    shortcut."""
    return (s <= tl.NEG_INF) & (s > -np.inf)


def seed_max(x, s):
    """The kernel's shortcut (max.NaN): the larger, NaN if x is NaN."""
    return torch.maximum(x, s)


def emulate_warp(a, b, seed, reverse, plan, landing, epoch=EPOCH):
    """Route A's schedule (``rnnt_lattice_warp_kernel``) in torch, all batch
    rows at once: ``(out, slow_steps)``. The ring starts as NaN. An epoch's
    puts land before the compute warps' first step of the epoch and the
    storing warp's reads (``landing="early"``: a put over a cell still to
    be read or stored would show) or after their last (``"late"``: a read
    of a row not yet put would show); the barrier that ends an epoch orders
    everything else. The compute threads leave each cell's value in the
    seed ring in place of its seed, and the storing warp stores finished
    rows from there, as the kernel does. ``slow_steps`` counts, per batch
    row, the steps at which a warp's vote took the second logaddexp."""
    bsz, rows, u1 = seed.shape
    diags = plan.ring
    width = compute = 32 * -(-u1 // 32)
    steps = rows + u1 - 1
    ring = torch.full((3, bsz, diags, width), float("nan"))  # a, b, seed
    out = torch.full_like(seed, float("nan"))

    def wrap(at):
        return torch.where(at >= diags, at - diags, at)

    def put(t):
        if t >= rows:
            return
        src_row = rows - 1 - t if reverse else t
        i = torch.arange(u1)
        u = u1 - 1 - i if reverse else i
        at = wrap(t % diags + u)
        ring[2][:, at, u] = seed[:, src_row, i]
        if t >= 1:
            ring[0][:, at, u] = a[:, src_row if reverse else src_row - 1, i]
        if reverse:
            if t >= 1:
                ring[1][:, at, u] = b[:, src_row, i]
        else:
            keep = u + 1 < u1
            ring[1][:, wrap(t % diags + u[keep] + 1), u[keep] + 1] = \
                b[:, src_row, i[keep]]

    def store(r):
        i = torch.arange(u1)
        u = u1 - 1 - i if reverse else i
        out[:, rows - 1 - r if reverse else r, i] = \
            ring[2][:, wrap(r % diags + u), u]

    for t in range(epoch + 1):
        put(t)
    cur = ring[:, :, 0, :].clone()
    v = torch.full((bsz, width), tl.NEG_INF)
    u = torch.arange(width)
    edge = torch.zeros(2, bsz, compute // 32)
    slow_steps = torch.zeros(bsz, dtype=torch.long)
    next_row = 0
    for e in range(-(-steps // epoch)):
        staged = range((e + 1) * epoch + 1, (e + 2) * epoch + 1)
        if landing == "early":              # the staging warp
            for t in staged:
                put(t)
        while next_row <= e * epoch - u1:   # the storing warp
            store(next_row)
            next_row += 1
        for d in range(e * epoch, min((e + 1) * epoch, steps)):
            # the compute warps: diagonal d + 1's panel values first; the
            # neighbour from lane l - 1 (__shfl_up_sync by 1; lane 0 gets
            # its own) or, for lane 0 of warp w > 0, from warp w - 1's last
            # lane by `edge`
            nxt = ring[:, :, (d + 1) % diags, :].clone()
            lanes = v.view(bsz, compute // 32, 32)
            left = torch.cat([lanes[..., :1], lanes[..., :-1]], dim=-1)
            left[:, 1:, 0] = edge[(d + 1) % 2][:, :-1]
            left = left.reshape(bsz, width)
            t = d - u
            stay = torch.where(t >= 1, v + cur[0], tl.NEG_INF)
            move = torch.where((u >= 1) & ((t >= 1) | (not reverse)),
                               left + cur[1], tl.NEG_INF)
            x = torch.logaddexp(stay, move)
            live = (t >= 0) & (t < rows) & (u < u1)
            short = seed_is_low(cur[2])       # the vote reads the seeds
            slow_steps += (live & ~short).any(dim=1)
            x = torch.where(short, seed_max(x, cur[2]),
                            torch.logaddexp(x, cur[2]))
            edge[d % 2] = x.view(bsz, compute // 32, 32)[..., -1]
            ring[2][:, d % diags, live] = x[:, live]
            v, cur = x, nxt
        if landing == "late":
            for t in staged:
                put(t)
    while next_row < rows:
        store(next_row)
        next_row += 1
    return out, slow_steps


def _panels(bsz, t_max, u1, seed_):
    """The alpha and the masked beta panels of random logits, as the loss
    makes them: ragged lengths, the last row's target empty."""
    rng = np.random.default_rng(seed_)
    v = 6
    logits = torch.from_numpy(rng.standard_normal(
        (bsz, t_max, u1, v)).astype(np.float32))
    targets = torch.from_numpy(rng.integers(1, v, (bsz, u1 - 1))).int()
    t_len = torch.tensor([t_max] + [max(1, t_max - 2 * i - 1)
                                    for i in range(1, bsz)], dtype=torch.int32)
    u_len = torch.tensor([u1 - 1] + [(u1 - 1) * (bsz - 1 - i) // bsz
                                     for i in range(1, bsz)],
                         dtype=torch.int32)
    u_len[-1] = 0
    lse = torch.logsumexp(logits, -1)
    skip, emit_pad = tl._gather_skip_emit(logits, lse, targets, 0)
    seed = torch.full_like(skip, tl.NEG_INF)
    seed[:, 0, 0] = 0.0
    return ((skip, emit_pad, seed),
            tl._masked_panels(logits, lse, targets, t_len, u_len, 0))


@pytest.fixture
def one_logaddexp(monkeypatch):
    """torch's CPU ``logaddexp`` can round the last bit one way in its
    vector body and the other in its scalar tail (-57.50639 against
    -57.506386 for the same two f32 values), so which bits a cell gets
    depends on where it sits in the tensor. Both sides of a bitwise
    comparison of schedules take this one instead: the same f32 values,
    evaluated in f64 and rounded to f32, which is the same at every
    position."""
    lae = torch.logaddexp

    def logaddexp(x, y):
        return lae(torch.as_tensor(x).double(),
                   torch.as_tensor(y).double()).float()

    monkeypatch.setattr(torch, "logaddexp", logaddexp)


@pytest.mark.parametrize("landing", ["early", "late"])
@pytest.mark.parametrize("u1,t_max", [(1, 9), (5, 12), (33, 7), (81, 20),
                                      (L, 6)])
def test_route_a_schedule_matches_plain_bit_for_bit(one_logaddexp, u1, t_max,
                                                    landing):
    """Alpha on the whole grid and masked beta on the whole grid, every bit
    equal to ``lattice_plain``; the second logaddexp taken at one step a
    row: alpha's (0, 0), beta's seed cell (beta's dead region takes the
    shortcut too)."""
    fwd, rev = _panels(3, t_max, u1, 7 + u1)
    for panels, reverse in ((fwd, False), (rev, True)):
        plan = tl.lattice_plan(3, panels[2].shape[1], u1, reverse, _Lib())
        assert plan.route == "warp"
        got, slow = emulate_warp(*panels, reverse, plan, landing)
        want = tl.lattice_plain(*panels, reverse=reverse)
        assert torch.equal(got, want), (got - want).abs().max()
        assert (slow == 1).all(), slow


@pytest.mark.parametrize("landing", ["early", "late"])
@pytest.mark.parametrize("epoch,helpers", [(2, 2), (6, 3)])
def test_route_a_schedule_of_other_builds(one_logaddexp, epoch, helpers,
                                          landing):
    """The tuning builds' epochs with the ring their own plan gives: alpha
    and masked beta still bit for bit."""
    fwd, rev = _panels(2, 11, 33, 3)
    for panels, reverse in ((fwd, False), (rev, True)):
        plan = tl.lattice_plan(2, panels[2].shape[1], 33, reverse,
                               _Lib(epoch, helpers))
        got, _ = emulate_warp(*panels, reverse, plan, landing, epoch)
        assert torch.equal(got, tl.lattice_plain(*panels, reverse=reverse))


def test_emulation_sees_a_ring_too_short(one_logaddexp):
    """A ring two diagonals shorter puts rows over cells the storing warp
    has not stored yet, and the emulation shows it."""
    fwd, _ = _panels(2, 80, 33, 5)
    plan = tl.lattice_plan(2, 80, 33, False, _Lib())
    assert plan.ring == 33 + 3 * EPOCH + 1
    short = plan._replace(ring=plan.ring - 2)
    got, _ = emulate_warp(*fwd, False, short, "early")
    assert not torch.equal(got, tl.lattice_plain(*fwd))


# ------------------------------------------------- the shortcut's identity
def _kernel_logaddexp(x, y):
    """The kernel's form, in f32: fmaxf(x, y) + log1pf(expf(-|x - y|))
    (fmaxf drops a NaN, as torch.fmax does)."""
    return torch.fmax(x, y) + torch.log1p(torch.exp(-(x - y).abs()))


def _xs():
    """x over the f32 range: a grid around -1e30 and 0 with the
    infinities, 1e5 log-spaced negatives and 1e5 values in [-1e5, 1e5]."""
    rng = np.random.default_rng(0)
    grid = np.array([-3.4e38, -2e30, np.nextafter(np.float32(-1e30),
                                                  np.float32(-np.inf)),
                     -1e30, np.nextafter(np.float32(-1e30), np.float32(0)),
                     -9.99e29, -1e29, -1e20, -1e5, -88.7, -1.0, -1e-30, 0.0,
                     1e-30, 1.0, 88.7, 1e5, 3.4e38, -np.inf, np.inf],
                    dtype=np.float32)
    logs = -(10.0 ** rng.uniform(-3, 38, 100000)).astype(np.float32)
    lin = rng.uniform(-1e5, 1e5, 100000).astype(np.float32)
    return torch.from_numpy(np.concatenate([grid, logs, lin]))


def _same(got, want):
    """Equal bit for bit, NaN where NaN."""
    nan = want != want
    return bool(torch.equal(got != got, nan)
                and torch.equal(got[~nan], want[~nan]))


@pytest.mark.parametrize("s", [tl.NEG_INF, -2e30, -3.4e38])
def test_seed_shortcut_is_the_kernels_logaddexp(s):
    """For a finite seed s <= -1e30, max(x, s) (NaN for a NaN x) is the
    kernel's logaddexp(x, s) bit for bit over the f32 range of x, the
    infinities included. A strided view takes torch's scalar loop, the
    contiguous tensor its vector body."""
    x = torch.cat([_xs(), torch.tensor([float("nan")])])
    sv = torch.full_like(x, s)
    assert seed_is_low(sv).all()
    assert _same(seed_max(x, sv), _kernel_logaddexp(x, sv))
    strided = torch.stack([x, x], 1)[:, 0]
    assert _same(seed_max(strided, sv), _kernel_logaddexp(strided, sv))


def test_seed_vote_sends_the_rest_to_logaddexp():
    """A seed above -1e30, a NaN seed and an infinite one take logaddexp:
    at s = -inf the shortcut would give -inf where the kernel's logaddexp
    of x = -inf gives NaN."""
    s = torch.tensor([0.0, -9.99e29, float("nan"), -np.inf, np.inf])
    assert not seed_is_low(s).any()
    x = torch.tensor([-np.inf])
    assert _kernel_logaddexp(x, torch.tensor([-np.inf])).isnan().all()
    assert seed_max(x, torch.tensor([-np.inf])).item() == -np.inf


@pytest.mark.parametrize("form", ["torch", "kernel"])
def test_seed_shortcut_identity(form):
    """logaddexp(x, -1e30) == x bit for bit for finite x >= -1e30, in torch
    and in the kernel's form; for x < -1e30 it is -1e30, the larger, so
    the shortcut is fmax and not x: -2e30 does not give itself back."""
    lae = torch.logaddexp if form == "torch" else _kernel_logaddexp
    x = _xs()
    x = x[(x >= tl.NEG_INF) & torch.isfinite(x)]
    assert torch.equal(lae(x, torch.full_like(x, tl.NEG_INF)), x)
    below = torch.tensor([-2e30, -1.0000001e30, -3.4e38])
    neg = torch.full_like(below, tl.NEG_INF)
    assert not torch.equal(lae(below, neg), below)
    assert torch.equal(lae(below, neg), torch.maximum(below, neg))
    assert lae(torch.tensor([-2e30]), torch.tensor([tl.NEG_INF])).item() \
        == np.float32(-1e30)
