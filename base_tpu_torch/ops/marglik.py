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


def _abg(obs, inv_var, lo, hi):
    """Residual-form band contractions alpha, beta, gamma [C, S, T] (and
    the pieces the backward reuses)."""
    d = (hi - lo)[:, None]                               # [C, 1, T, B]
    r = obs[None, :, None, :] - lo[:, None]              # [C, S, T, B]
    iv = inv_var[None, :, None, :]                       # [1, S, 1, B]
    alpha = (iv * d * d).sum(-1)
    beta = (iv * r * d).sum(-1)
    gamma = (iv * r * r).sum(-1)
    return alpha, beta, gamma, d, r, iv


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
    {0, 1} float.  Linear-space accumulation: exp(core - m) * width summed
    over segments, one log per star."""
    alpha, beta, gamma, _, _, _ = _abg(obs, inv_var, lo, hi)
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
    return out + log_norm


def marglik_bwd_plain(obs, inv_var, log_norm, lo, hi, logw, mask, out, g):
    """Plain version of kernel 4: analytic (dlo [C, T, B], dhi [C, T, B],
    dlogw [C, T]) for the cotangent g [C, S] of marglik_fwd_plain."""
    alpha, beta, gamma, d, r, iv = _abg(obs, inv_var, lo, hi)
    mask = (mask > 0.5)[:, None, :]
    core, width, aux = _core_width(alpha, beta, gamma, logw[:, None, :], mask)
    u0, u1, width_s, unear_sq, live, mu, rsq = aux
    # exp(core - out') * width = term / sum: the softmax weight.
    outp = (out - log_norm)[:, :, None]
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
    ga = (gw * (-0.5) * t2)[..., None]
    gb = (gw * t1)[..., None]
    gc = (gw * (-0.5))[..., None]
    # d alpha/d lo = -2 iv d; d beta/d lo = -iv (d + r); d gamma/d lo =
    # -2 iv r; d alpha/d hi = 2 iv d; d beta/d hi = iv r.
    dlo = (iv * (-2.0 * ga * d - gb * (d + r) - 2.0 * gc * r)).sum(1)
    dhi = (iv * (2.0 * ga * d + gb * r)).sum(1)
    return dlo, dhi, gw.sum(1)


_NAMES = ("obs", "inv_var", "log_norm", "lo", "hi", "logw", "maskf")


def _checked(args):
    obs, lo = args[0], args[3]
    S, B = obs.shape
    C, T = lo.shape[:2]
    if B > 16:
        raise ValueError(f"marginal kernels take at most 16 bands, got {B}")
    shapes = [(S, B), (S, B), (S,), (C, T, B), (C, T, B), (C, T), (C, T)]
    for name, t, shape in zip(_NAMES, args, shapes):
        build.check(name, t, shape)
    return C, S, T, B


def marglik_fwd_cuda(obs, inv_var, log_norm, lo, hi, logw, maskf):
    """Kernel 3 on the card: [C, S]."""
    global marglik_fwd_launches
    args = (obs, inv_var, log_norm, lo, hi, logw, maskf)
    C, S, T, B = _checked(args)
    out = torch.empty((C, S), dtype=torch.float32, device=obs.device)
    build.launch("btt_marglik_fwd", [*args, out], (C, S, T, B))
    marglik_fwd_launches += 1
    return out


def marglik_bwd_cuda(obs, inv_var, log_norm, lo, hi, logw, maskf, out, g):
    """Kernel 4 on the card: (dlo, dhi, dlogw) as marglik_bwd_plain."""
    global marglik_bwd_launches
    args = (obs, inv_var, log_norm, lo, hi, logw, maskf)
    C, S, T, B = _checked(args)
    build.check("out", out, (C, S))
    build.check("g", g, (C, S))
    dlo = torch.empty_like(lo)
    dhi = torch.empty_like(hi)
    dlogw = torch.empty_like(logw)
    build.launch("btt_marglik_bwd", [*args, out, g, dlo, dhi, dlogw],
                 (C, S, T, B))
    marglik_bwd_launches += 1
    return dlo, dhi, dlogw


class _FusedMarglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        if args[0].is_cuda:
            out = marglik_fwd_cuda(*args)
        else:
            out = marglik_fwd_plain(*args)
        ctx.save_for_backward(*args, out)
        return out

    @staticmethod
    def backward(ctx, g):
        *args, out = ctx.saved_tensors
        if g.is_cuda:
            dlo, dhi, dlogw = marglik_bwd_cuda(*args, out, g.contiguous())
        else:
            dlo, dhi, dlogw = marglik_bwd_plain(*args, out, g)
        dln = g.sum(0) if ctx.needs_input_grad[2] else None
        return None, None, dln, dlo, dhi, dlogw, None


def fused_log_marginals(
    obs: torch.Tensor,       # [S, B]
    inv_var: torch.Tensor,   # [S, B]
    log_norm: torch.Tensor,  # [S]
    lo: torch.Tensor,        # [C, T, B]
    hi: torch.Tensor,        # [C, T, B]
    logw: torch.Tensor,      # [C, T]
    maskf: torch.Tensor,     # [C, T] float {0, 1}
) -> torch.Tensor:
    """Per-star log marginal cluster likelihood of every chain: [C, S].
    Differentiable with respect to log_norm, lo, hi and logw."""
    return _FusedMarglik.apply(obs, inv_var, log_norm, lo, hi, logw, maskf)
