"""Segment-exact per-star marginal likelihood: kernels 3 and 4
(csrc/marglik.cu).

Port of base_tpu/ops/pallas_marglik.py (residual-form band loop) with a
leading chain axis on the table.  Per (chain c, star s, segment t), with
chi2(u) = alpha u^2 - 2 beta u + gamma on the segment coordinate u in [0, 1]:

    term = exp(-chi2_min/2 + logw - m) * sqrt(2pi/alpha) * Phi-difference
    out[c, s] = m + log(sum_t term + 1e-15) + log_norm[s]

`marglik_fwd_plain` is the plain version of kernel 3 and IS the port's
`model.likelihood.ms_star_log_marginals`.  The backward is analytic, as in
base_tpu: softmax weights from the saved output and d log I / d(alpha,
beta, gamma) = (-<t^2>/2, <t>, -1/2) from the [0,1]-truncated Gaussian
moments (`marglik_bwd_plain` beside kernel 4).  The photometry is data and
gets no cotangent; d out / d log_norm is the identity.

Star sets (the port's counterpart of base_tpu's `vmap` over data sets):
obs and inv_var [G, S, B] and log_norm [G, S] beside tables [C, T, B],
with C a multiple of G, score chain c on set c // (C // G) (`chain_rows`).
Kernels 3 and 4 and their plain versions take both forms; one set [S, B]
runs exactly the one-set code.  The matmul form takes one set.

Almost every softmax weight is an exact 0.0 in float32 (98% at config-1):
`marglik_bwd_group_skip` (before any band contraction, for 32 segments at
once) and `marglik_bwd_skip` (after it, per element) are the rules by which
kernel 4 finds them and skips the rest of their work.

`fused_log_marginals(..., matmul=True)` is base_tpu's MXU form: alpha, beta
and gamma from the expanded quadratic as five [S, B] @ [B, T] products
(`_abg_mm`, base_tpu's `_abg_matmul`), the cotangents by five star-axis
products, after a per-band centering of obs, lo and hi.  Kernels 3m and 4m
(csrc/marglik_mm.cu) carry it on the card; `marglik_mm_fwd_plain` and
`marglik_mm_bwd_plain` are their plain versions.  Off by default, as in
base_tpu: the expansion cancels in float32, more so as B grows.  Kernel 4m
skips by `marglik_mm_bwd_group_skip`, kernel 4's group rule with a slack
widened to the expansion's rounding.
"""
from __future__ import annotations

import torch

from base_tpu_torch.ops import build
from base_tpu_torch.ops.special import NEG_INF, phi_interval_scaled

SQRT_2PI = 2.5066282746310002
INV_SQRT_2PI = 0.3989422804014327
_ALPHA_EPS = 1e-12
_FLAT_EPS = 3e-7   # erf-cancellation guard: flat segments use the midpoint

# Kernel launches since the last reset; the wrappers add one per launch.
marglik_fwd_launches = 0
marglik_bwd_launches = 0
marglik_mm_fwd_launches = 0
marglik_mm_bwd_launches = 0


def chain_rows(x: torch.Tensor, C: int) -> torch.Tensor:
    """Per-set rows x [G, ...] as the C chains see them, [C, ...]: chain c
    takes set c // (C // G)."""
    G = x.shape[0]
    if G < 1 or C % G:
        raise ValueError(f"{C} chains do not split evenly over {G} star "
                         f"sets")
    return x if G == C else x.repeat_interleave(C // G, 0)


def _per_chain(x: torch.Tensor, C: int, ndim: int) -> torch.Tensor:
    """Star data as the chains see it: one set (`ndim` axes) as it is, to
    broadcast over the chains; star sets (a leading [G] axis) by
    chain_rows."""
    return x if x.ndim == ndim else chain_rows(x, C)


def _one_set(obs: torch.Tensor, what: str) -> None:
    if obs.ndim != 2:
        raise ValueError(f"{what} takes one star set (obs [S, B]), got obs "
                         f"{tuple(obs.shape)}: star sets run through "
                         f"kernels 3 and 4 (matmul=False)")


def _abg(obs, inv_var, lo, hi):
    """Residual-form band contractions alpha, beta, gamma [C, S, T] (and
    the pieces the backward reuses)."""
    C = lo.shape[0]
    d = (hi - lo)[:, None]                               # [C, 1, T, B]
    r = _per_chain(obs, C, 2)[..., None, :] - lo[:, None]  # [C, S, T, B]
    iv = _per_chain(inv_var, C, 2)[..., None, :]         # [(C,) S, 1, B]
    alpha = (iv * d * d).sum(-1)
    beta = (iv * r * d).sum(-1)
    gamma = (iv * r * r).sum(-1)
    return alpha, beta, gamma, d, r, iv


def _fma(x, y, acc):
    """acc + x * y rounded once, as an FFMA rounds it.  In float32 the
    product is exact in float64, the sum there is made round-to-odd from
    its exact error (TwoSum), and rounding that to float32 gives the
    correctly rounded result; other dtypes round twice."""
    if acc.dtype != torch.float32:
        return acc + x * y
    a, p = acc.double(), x.double() * y.double()
    s = a + p
    t = s - a
    err = (a - (s - t)) + (p - t)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _fma_dot(u, v):
    """[S, B] x [C, B, T] -> [C, S, T]: sum over bands of u v, accumulated
    band by band in order from 0 by _fma, as kernels 3m and 4m do."""
    acc = u.new_zeros((v.shape[0], u.shape[0], v.shape[2]))
    for b in range(u.shape[1]):
        acc = _fma(u[None, :, b, None], v[:, None, b, :], acc)
    return acc


def _abg_mm(obs, inv_var, lo, hi):
    """Kernel 3m's band contractions alpha, beta, gamma [C, S, T]: base_tpu's
    `_abg_matmul`, the quadratic expanded into five [S, B] @ [C, B, T]
    products (float32 throughout) and gamma clamped at 0.  The products
    (and c0) are summed in the kernels' own order, so the expansion's
    float32 rounding, which at wide B reaches whole nats (~ulp of
    sum_b iv obs^2), is the same in both and the kernels are held to this
    version as tightly as kernel 3 to its own."""
    _one_set(obs, "the matmul form")
    ivo = inv_var * obs                                  # [S, B]
    c0 = obs.new_zeros(obs.shape[0])
    for b in range(obs.shape[1]):
        c0 = _fma(ivo[:, b], obs[:, b], c0)
    dT = (hi - lo).transpose(1, 2)                       # [C, B, T]
    loT = lo.transpose(1, 2)
    alpha = _fma_dot(inv_var, dT * dT)
    beta = _fma_dot(ivo, dT) - _fma_dot(inv_var, loT * dT)
    gamma = c0[:, None] - 2.0 * _fma_dot(ivo, loT) \
        + _fma_dot(inv_var, loT * loT)
    return alpha, beta, gamma.clamp_min(0.0)


def _core_width(alpha, beta, gamma, logw, mask):
    """(core, width, aux) as a function of (alpha, beta, gamma): core =
    -chi2_min/2 + logw (NEG_INF where masked), width = sqrt(2pi/alpha) *
    scaled Phi-difference (1 for flat segments)."""
    ac = alpha.clamp_min(_ALPHA_EPS)
    rsq = torch.rsqrt(ac)
    inv_a = rsq * rsq
    mu = beta * inv_a
    resid = (gamma - beta * mu).clamp_min(0.0)
    sq = ac * rsq
    u0 = -mu * sq
    u1 = sq - mu * sq
    # Scaled Phi-difference + the true on-segment chi2 minimum in the core
    # (resid + u_near^2), so the max-shift is tight in the tails.
    width_s, unear_sq = phi_interval_scaled(u0, u1)
    live = alpha > _FLAT_EPS
    mid = gamma - beta + 0.25 * alpha
    core = torch.where(live, -0.5 * (resid + unear_sq), -0.5 * mid) + logw
    core = torch.where(mask, core, torch.full_like(core, NEG_INF))
    width = torch.where(live, SQRT_2PI * rsq * width_s,
                        torch.ones_like(width_s))
    return core, width, (u0, u1, width_s, unear_sq, live, mu, rsq)


def marglik_fwd_plain(obs, inv_var, log_norm, lo, hi, logw, mask):
    """Plain version of kernel 3: [C, S].  `mask` [C, T] is bool or a
    {0, 1} float; obs, inv_var and log_norm one star set or star sets.
    Linear-space accumulation: exp(core - m) * width summed over
    segments, one log per star."""
    alpha, beta, gamma, _, _, _ = _abg(obs, inv_var, lo, hi)
    return _log_marginals(alpha, beta, gamma, log_norm, logw, mask)


def marglik_mm_fwd_plain(obs, inv_var, log_norm, lo, hi, logw, mask):
    """Plain version of kernel 3m: marglik_fwd_plain on the expanded
    contractions (`_abg_mm`)."""
    return _log_marginals(*_abg_mm(obs, inv_var, lo, hi), log_norm, logw,
                          mask)


def _log_marginals(alpha, beta, gamma, log_norm, logw, mask):
    mask = (mask > 0.5)[:, None, :]                      # [C, 1, T]
    core, width, _ = _core_width(alpha, beta, gamma, logw[:, None, :], mask)
    m = torch.amax(core, dim=-1, keepdim=True).clamp_min(NEG_INF)
    terms = torch.exp(core - m) * width
    terms = torch.where(mask, terms, torch.zeros_like(terms))
    s = terms.sum(-1)
    # Additive 1e-15 floor: 1/s enters the cotangent chain, and a tiny
    # floor makes cotangents that overflow against the rsqrt/erf factors.
    out = m.squeeze(-1) + torch.log(s + 1e-15)
    out = torch.where(s > 0, out, torch.full_like(out, NEG_INF))
    return out + _per_chain(log_norm, out.shape[0], 1)


def marglik_bwd_plain(obs, inv_var, log_norm, lo, hi, logw, mask, out, g):
    """Plain version of kernel 4: analytic (dlo [C, T, B], dhi [C, T, B],
    dlogw [C, T]) for the cotangent g [C, S] of marglik_fwd_plain."""
    alpha, beta, gamma, d, r, iv = _abg(obs, inv_var, lo, hi)
    gw, ga, gb, gc = _cotangent_weights(alpha, beta, gamma, log_norm, logw,
                                        mask, out, g)
    ga, gb, gc = ga[..., None], gb[..., None], gc[..., None]
    # d alpha/d lo = -2 iv d; d beta/d lo = -iv (d + r); d gamma/d lo =
    # -2 iv r; d alpha/d hi = 2 iv d; d beta/d hi = iv r.
    dlo = (iv * (-2.0 * ga * d - gb * (d + r) - 2.0 * gc * r)).sum(1)
    dhi = (iv * (2.0 * ga * d + gb * r)).sum(1)
    return dlo, dhi, gw.sum(1)


def marglik_mm_bwd_plain(obs, inv_var, log_norm, lo, hi, logw, mask, out,
                         g):
    """Plain version of kernel 4m: marglik_bwd_plain's cotangents through
    the expanded contractions, the star axis contracted by five products
    (base_tpu's `_bwd_kernel` under `mm`): A1 = iv^T ga, B1 = iv^T gb, B2 =
    (iv obs)^T gb, C1 = iv^T gc, C2 = (iv obs)^T gc, each [C, B, T]."""
    _one_set(obs, "the matmul form")
    gw, ga, gb, gc = _cotangent_weights(*_abg_mm(obs, inv_var, lo, hi),
                                        log_norm, logw, mask, out, g)
    ivT = inv_var.T
    ivoT = (inv_var * obs).T                             # [B, S]
    A1, B1, C1 = ivT @ ga, ivT @ gb, ivT @ gc
    B2, C2 = ivoT @ gb, ivoT @ gc
    dT = (hi - lo).transpose(1, 2)
    loT = lo.transpose(1, 2)
    dhi = 2.0 * dT * A1 + (B2 - loT * B1)
    dlo = -2.0 * dT * A1 - (dT * B1 + B2 - loT * B1) - 2.0 * (C2 - loT * C1)
    return (dlo.transpose(1, 2).contiguous(),
            dhi.transpose(1, 2).contiguous(), gw.sum(1))


def _cotangent_weights(alpha, beta, gamma, log_norm, logw, mask, out, g):
    """(gw, ga, gb, gc) [C, S, T]: g times the softmax weight, and its
    products with d log I / d(alpha, beta, gamma) = (-<t^2>/2, <t>, -1/2)
    from the [0,1]-truncated Gaussian moments."""
    mask = (mask > 0.5)[:, None, :]
    core, width, aux = _core_width(alpha, beta, gamma, logw[:, None, :], mask)
    u0, u1, width_s, unear_sq, live, mu, rsq = aux
    # exp(core - out') * width = term / sum: the softmax weight.
    outp = (out - _per_chain(log_norm, out.shape[0], 1))[:, :, None]
    gw = g[:, :, None] * torch.exp(core - outp) * width
    gw = torch.where(mask, gw, torch.zeros_like(gw))
    phi_s0 = INV_SQRT_2PI * torch.exp(
        0.5 * torch.clamp(unear_sq - u0 * u0, max=0.0))
    phi_s1 = INV_SQRT_2PI * torch.exp(
        0.5 * torch.clamp(unear_sq - u1 * u1, max=0.0))
    zs = width_s.clamp_min(1e-12)
    r1 = (phi_s0 - phi_s1) / zs
    sigma = rsq
    t1 = (mu + sigma * r1).clamp(0.0, 1.0)                       # <t>
    t2 = (
        sigma * sigma * (1.0 + (u0 * phi_s0 - u1 * phi_s1) / zs)
        + mu * mu + 2.0 * mu * sigma * r1
    ).clamp(0.0, 1.0)                                            # <t^2>
    # Flat branch: the midpoint value's sensitivities are the t -> 1/2
    # point moments.
    t1 = torch.where(live, t1, torch.full_like(t1, 0.5))
    t2 = torch.where(live, t2, torch.full_like(t2, 0.25))
    return gw, gw * (-0.5) * t2, gw * t1, gw * (-0.5)


# Kernel 4's skip rule: expf of anything below about -104 is 0.0f.
_SKIP_BELOW = -105.0
# At least log of the largest width, sqrt(2 pi / _FLAT_EPS) ~ e^8.4 (the
# scaled Phi-difference is at most ~1), with room to spare.
_SKIP_LOG_WIDTH = 16.0
# Float32 rounding of chi2c here and of resid + unear_sq in core_width,
# relative to the magnitudes that cancel in them.
_SKIP_REL = 1e-5


def marglik_bwd_skip(obs, inv_var, log_norm, lo, hi, logw, mask, out):
    """Kernel 4's skip rule: bool [C, S, T], True where the softmax weight
    exp(core - out') * width of marglik_bwd_plain is certain to be an exact
    0.0, so that the element adds nothing to dlo, dhi or dlogw.

    chi2c = (alpha u - 2 beta) u + gamma at u = clamp(beta / alpha, 0, 1) is
    the on-segment minimum of chi2: resid + unear_sq on the live branch, at
    most `mid` on the flat one.  So core <= -chi2c / 2 + logw, up to the
    rounding that _SKIP_REL covers, and log width <= _SKIP_LOG_WIDTH.  An
    element is skipped when that bound on log(weight) lies below
    _SKIP_BELOW.  Masked segments (already zero) are never marked, nor is a
    NaN bound, and out' = NEG_INF (a star with no live segment) gives a
    huge bound.  csrc/marglik.cu follows these float32 operations in this
    order, without FMA contraction; its alpha, beta and gamma come from its
    own contraction, which may round otherwise in the last bit, and the
    margins cover that as they cover any float32 rounding."""
    alpha, beta, gamma, _, _, _ = _abg(obs, inv_var, lo, hi)
    u = (beta / alpha.clamp_min(_ALPHA_EPS)).clamp(0.0, 1.0)
    chi2c = (alpha * u - 2.0 * beta) * u + gamma
    outp = out - _per_chain(log_norm, out.shape[0], 1)
    zero = _zero_weight(chi2c, logw[:, None, :], outp[:, :, None],
                        gamma.abs() + 2.0 * beta.abs() + alpha)
    return (mask > 0.5)[:, None, :] & zero


def _zero_weight(chi2, logw, outp, scale, rel=_SKIP_REL):
    """True where a softmax weight whose chi2 is at least `chi2` is
    certain to be 0.0: the bound on its log, with a slack of `rel` times
    `scale`, the magnitudes that cancel in chi2, lies below _SKIP_BELOW."""
    slack = rel * scale
    return -0.5 * chi2 + logw - outp + _SKIP_LOG_WIDTH + slack < _SKIP_BELOW


# Segments per group of kernel 4's group rule: the 32 lanes of one warp.
SKIP_GROUP = 32


def _group_ranges(lo, hi, logw, mask):
    """Per (chain, group of SKIP_GROUP segments): the least and the largest
    of the live segments' lo and hi in each band, mn and mx [C, 1, G, B]
    (+inf and -inf where no segment is live), and their largest logw mlw
    [C, 1, G] (-inf there)."""
    C, T, B = lo.shape
    G = -(-T // SKIP_GROUP)
    pad = G * SKIP_GROUP - T
    live = mask > 0.5
    inf = torch.full_like(lo, torch.inf)
    mn = torch.where(live[..., None], torch.minimum(lo, hi), inf)
    mx = torch.where(live[..., None], torch.maximum(lo, hi), -inf)
    mn = torch.nn.functional.pad(mn, (0, 0, 0, pad), value=torch.inf)
    mx = torch.nn.functional.pad(mx, (0, 0, 0, pad), value=-torch.inf)
    mn = mn.reshape(C, G, SKIP_GROUP, B).amin(2)[:, None]     # [C, 1, G, B]
    mx = mx.reshape(C, G, SKIP_GROUP, B).amax(2)[:, None]
    lw = torch.where(live, logw, torch.full_like(logw, -torch.inf))
    lw = torch.nn.functional.pad(lw, (0, pad), value=-torch.inf)
    mlw = lw.reshape(C, G, SKIP_GROUP).amax(2)[:, None]       # [C, 1, G]
    return mn, mx, mlw


def marglik_bwd_group_skip(obs, inv_var, log_norm, lo, hi, logw, mask, out):
    """Kernel 4's group rule: bool [C, S, ceil(T / SKIP_GROUP)], True where
    every element of the (chain, star, group of SKIP_GROUP consecutive
    segments) is certain to have an exact 0.0 softmax weight, found before
    any band contraction.

    Per band, the group's live segments lie in [mn_b, mx_b] (the least and
    the largest of their lo and hi), so every chi2 on them is at least
    lb = sum_b iv_b dist(o_b, [mn_b, mx_b])^2, and the terms of
    marglik_bwd_skip's slack are at most Gm = sum iv R^2 >= gamma,
    Bt = sum iv R W >= |beta| and A = sum iv W^2 >= alpha, with
    R = max(|o - mn|, |o - mx|) and W = mx - mn.  The rule is
    marglik_bwd_skip's with lb for chi2c, the group's largest live logw for
    logw and (Gm, Bt, A) in the slack.  A group with no live segment gives
    NaN and is never marked.  The bands are summed in order, so that
    csrc/marglik.cu can repeat these float32 operations exactly."""
    C, _, B = lo.shape
    mn, mx, mlw = _group_ranges(lo, hi, logw, mask)
    lb = gm = bt = a = lo.new_zeros((C, obs.shape[-2], mlw.shape[2]))
    obs, inv_var = _per_chain(obs, C, 2), _per_chain(inv_var, C, 2)
    for b in range(B):
        o = obs[..., :, None, b]                         # [(C,) S, 1]
        w = inv_var[..., :, None, b]
        lo_b, hi_b = mn[..., b], mx[..., b]
        dist = torch.maximum(lo_b - o, o - hi_b).clamp_min(0.0)
        r = torch.maximum((o - lo_b).abs(), (o - hi_b).abs())
        width = hi_b - lo_b
        lb = lb + w * dist * dist
        gm = gm + w * r * r
        bt = bt + w * r * width
        a = a + w * width * width
    outp = out - _per_chain(log_norm, C, 1)
    return _zero_weight(lb, mlw, outp[:, :, None], gm + 2.0 * bt + a)


# Kernel 4m's group rule (below): alpha, beta and gamma of the matmul form
# are FMA chains over the expanded products, one a band, so each sits within
# (B + 3) units of 2^-24 of sum_b iv (|o| + |lo| + |d|)^2 from its exact
# value (the products c0, iv obs lo, iv lo^2, ... cancel down to chi2), and
# chi2's on-segment minimum moves at most |d alpha| + 2 |d beta| + |d gamma|.
# Half that in log units; the rule takes (B + 8) units, besides _SKIP_REL.
_MM_SKIP_ULPS = 8
_ULP = 2.0 ** -24


def marglik_mm_bwd_group_skip(obs, inv_var, log_norm, lo, hi, logw, mask,
                              out):
    """Kernel 4m's group rule: bool [C, S, ceil(T / SKIP_GROUP)], True where
    every element of the (chain, star, group of SKIP_GROUP segments) is
    certain to have an exact 0.0 softmax weight in marglik_mm_bwd_plain,
    found before any band contraction.  `obs`, `lo` and `hi` as the
    kernel takes them (centered: `center_bands`).

    marglik_bwd_group_skip's bound lb on chi2, with the slack widened to
    the expansion's rounding: E = sum_b iv (|o| + L + W)^2, with L =
    max(|mn|, |mx|) >= |lo| and W = mx - mn >= |d| on the group's live
    segments, bounds the magnitudes of every expanded product (and the
    residual form's Gm + 2 Bt + A), and the slack is (_SKIP_REL + (B +
    _MM_SKIP_ULPS) 2^-24) E.  A group with no live segment gives NaN and is
    never marked.  The bands are summed in order, so that
    csrc/marglik_mm.cu can repeat these float32 operations exactly."""
    _one_set(obs, "the matmul form")
    B = lo.shape[2]
    mn, mx, mlw = _group_ranges(lo, hi, logw, mask)
    lb = e = lo.new_zeros((lo.shape[0], obs.shape[0], mlw.shape[2]))
    for b in range(B):
        o = obs[None, :, None, b]                              # [1, S, 1]
        w = inv_var[None, :, None, b]
        lo_b, hi_b = mn[..., b], mx[..., b]
        dist = torch.maximum(lo_b - o, o - hi_b).clamp_min(0.0)
        span = o.abs() + torch.maximum(lo_b.abs(), hi_b.abs()) \
            + (hi_b - lo_b)
        lb = lb + w * dist * dist
        e = e + w * span * span
    return _zero_weight(lb, mlw, (out - log_norm)[:, :, None], e,
                        rel=_SKIP_REL + (B + _MM_SKIP_ULPS) * _ULP)


_NAMES = ("obs", "inv_var", "log_norm", "lo", "hi", "logw", "maskf")


def _checked(args, sets: bool):
    """(C, S, T, B) and the sizes the C entry point takes: those and, for
    kernels 3 and 4 (`sets`), the star sets' count G."""
    obs, lo = args[0], args[3]
    if not sets:
        _one_set(obs, "the matmul form")
    S, B = obs.shape[-2:]
    C, T = lo.shape[:2]
    G = obs.shape[0] if obs.ndim == 3 else 1
    build.check_bands("marginal", B)
    build.check_chains(C)
    if C % G:
        raise ValueError(f"{C} chains do not split evenly over {G} star "
                         f"sets")
    star = (G, S) if obs.ndim == 3 else (S,)
    shapes = [(*star, B), (*star, B), star, (C, T, B), (C, T, B), (C, T),
              (C, T)]
    for name, t, shape in zip(_NAMES, args, shapes):
        build.check(name, t, shape)
    return (C, S, T, B), (C, S, T, B, G) if sets else (C, S, T, B)


def _launch_fwd(symbol, args, sets: bool, scratch=None):
    (C, S, T, _), sizes = _checked(args, sets)
    out = torch.empty((C, S), dtype=torch.float32, device=args[0].device)
    extra = [] if scratch is None else [torch.empty(
        scratch(C, S, T), dtype=torch.float32, device=args[0].device)]
    build.launch(symbol, [*args, out, *extra], sizes)
    return out


def _launch_bwd(symbol, args, out, g, sets: bool):
    (C, S, _, _), sizes = _checked(args, sets)
    build.check("out", out, (C, S))
    build.check("g", g, (C, S))
    dlo = torch.empty_like(args[3])
    dhi = torch.empty_like(args[4])
    dlogw = torch.empty_like(args[5])
    build.launch(symbol, [*args, out, g, dlo, dhi, dlogw], sizes)
    return dlo, dhi, dlogw


def marglik_fwd_cuda(obs, inv_var, log_norm, lo, hi, logw, maskf):
    """Kernel 3 on the card: [C, S], over one star set or star sets."""
    global marglik_fwd_launches
    out = _launch_fwd("btt_marglik_fwd",
                      (obs, inv_var, log_norm, lo, hi, logw, maskf), True)
    marglik_fwd_launches += 1
    return out


def marglik_bwd_cuda(obs, inv_var, log_norm, lo, hi, logw, maskf, out, g):
    """Kernel 4 on the card: (dlo, dhi, dlogw) as marglik_bwd_plain."""
    global marglik_bwd_launches
    grads = _launch_bwd("btt_marglik_bwd",
                        (obs, inv_var, log_norm, lo, hi, logw, maskf), out, g,
                        True)
    marglik_bwd_launches += 1
    return grads


def marglik_mm_fwd_cuda(obs, inv_var, log_norm, lo, hi, logw, maskf):
    """Kernel 3m on the card: [C, S] as marglik_mm_fwd_plain.  Where the
    kernel splits the segments into chunks, the call is two CUDA launches
    (the chunks, then their merge in chunk order), counted as one launch of
    kernel 3m."""
    global marglik_mm_fwd_launches
    out = _launch_fwd("btt_marglik_mm_fwd",
                      (obs, inv_var, log_norm, lo, hi, logw, maskf), False,
                      scratch=build.marglik_mm_fwd_scratch)
    marglik_mm_fwd_launches += 1
    return out


def marglik_mm_bwd_cuda(obs, inv_var, log_norm, lo, hi, logw, maskf, out,
                        g):
    """Kernel 4m on the card: (dlo, dhi, dlogw) as marglik_mm_bwd_plain."""
    global marglik_mm_bwd_launches
    grads = _launch_bwd("btt_marglik_mm_bwd",
                        (obs, inv_var, log_norm, lo, hi, logw, maskf), out, g,
                        False)
    marglik_mm_bwd_launches += 1
    return grads


# (kernel, plain version) of each form, forward and backward.
_FORMS = {
    False: ((marglik_fwd_cuda, marglik_fwd_plain),
            (marglik_bwd_cuda, marglik_bwd_plain)),
    True: ((marglik_mm_fwd_cuda, marglik_mm_fwd_plain),
           (marglik_mm_bwd_cuda, marglik_mm_bwd_plain)),
}


class _FusedMarglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mm, *args):
        kernel, plain = _FORMS[mm][0]
        out = kernel(*args) if args[0].is_cuda else plain(*args)
        ctx.mm = mm
        ctx.save_for_backward(*args, out)
        return out

    @staticmethod
    def backward(ctx, g):
        *args, out = ctx.saved_tensors
        kernel, plain = _FORMS[ctx.mm][1]
        if g.is_cuda:
            dlo, dhi, dlogw = kernel(*args, out, g.contiguous())
        else:
            dlo, dhi, dlogw = plain(*args, out, g)
        dln = None
        if ctx.needs_input_grad[3]:   # g summed over each set's chains
            ln = args[2]
            dln = g.sum(0) if ln.ndim == 1 else g.reshape(
                ln.shape[0], -1, g.shape[1]).sum(1)
        return None, None, None, dln, dlo, dhi, dlogw, None


def fused_log_marginals(
    obs: torch.Tensor,       # [S, B] or star sets [G, S, B]
    inv_var: torch.Tensor,   # [S, B] or [G, S, B]
    log_norm: torch.Tensor,  # [S] or [G, S]
    lo: torch.Tensor,        # [C, T, B]
    hi: torch.Tensor,        # [C, T, B]
    logw: torch.Tensor,      # [C, T]
    maskf: torch.Tensor,     # [C, T] float {0, 1}
    matmul: bool | None = None,
) -> torch.Tensor:
    """Per-star log marginal cluster likelihood of every chain: [C, S].
    Differentiable with respect to log_norm, lo, hi and logw.  With star
    sets, chain c is scored on set c // (C // G).

    `matmul`: base_tpu's argument, the expanded form (kernels 3m, 4m).  obs,
    lo and hi are first centered per band (`center_bands`: a constant that
    cancels from every obs - model difference) to bound the expansion's
    float32 cancellation.  Default False, as in base_tpu."""
    if matmul:
        _one_set(obs, "the matmul form")
        obs, lo, hi = center_bands(obs, inv_var, lo, hi)
    return _FusedMarglik.apply(bool(matmul), obs, inv_var, log_norm, lo, hi,
                               logw, maskf)


def center_bands(obs, inv_var, lo, hi):
    """base_tpu's centering for the matmul form: (obs, lo, hi) less, per
    band, the mean magnitude of the stars observed in it (a constant
    without gradient), and obs 0 where unobserved."""
    seen = inv_var > 0
    c = (torch.where(seen, obs, 0.0).sum(0)
         / seen.sum(0).clamp_min(1)).detach()
    return torch.where(seen, obs - c, 0.0), lo - c, hi - c
