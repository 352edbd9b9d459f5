"""Depth-guided ray sampling, DINER's core contribution (port of
diner_tpu.sampler.depth_guided).

Per ray:
  1. `n_depth_candidates` stratified z candidates in [near, far].
  2. Each candidate's prior (MVS depth d, depth std sigma, normal) in every
     source view: by nearest-pixel gathers at its projection (exact branch),
     or from A epipolar anchors per (ray, view) (anchor branch, the fast
     preset), where kernel K1 does the remap and the likelihood, or, on the
     "chord" route, kernel K3 also the chord arithmetic.
  3. Surface likelihood p = mass of N(d, sigma^2) inside the candidate's
     depth bin, gated on front-facing normals, |d - z_cam| < depth_diff_max
     and valid sigma; max over views; an occlusion-aware variant multiplies
     by the transmittance of the earlier candidates.
  4. top-k candidates by p; the last `n_gaussian` slots drawn from N(mu, std)
     fitted to the occlusion-aware mass; empty slots refilled uniformly.

Randomness: jax.random draws cannot be reproduced in torch, so every draw is
an optional tensor argument (the uniform jitter of step 1, the Gaussian draw
and the fill uniform draw); without one the function draws from the
`torch.Generator` it is given.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from reference.core.types import (LIKELIHOOD_ROUTES, EpiAnchors,
                                        RenderConfig, SceneEncoding)
from reference.geometry import project_points, transform_points
from reference.kernels.chord import likelihood_from_chord
from reference.kernels.likelihood import likelihood_from_anchors
from reference.utils.stats import weighted_mean_and_std

_PAD, _DOUBLE_WIDTH = 100, 12.0  # exponential std padding (index_depth_std)


def _uniform(shape, like, generator):
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device)


def sample_stratified(rays, n: int, u=None, generator=None):
    """Stratified z samples in [near, far], one uniform draw per bin.

    rays (..., 8); u (..., n) the uniform draw in [0, 1). Returns (..., n).
    """
    near, far = rays[..., 6:7], rays[..., 7:8]
    if u is None:
        u = _uniform((*rays.shape[:-1], n), rays, generator)
    steps = torch.arange(n, dtype=rays.dtype, device=rays.device) / n
    s = steps + u / n
    return near * (1 - s) + far * s


def _pixel(uv, W: int, H: int):
    return (uv[..., 0] + 1.0) * 0.5 * W - 0.5, (uv[..., 1] + 1.0) * 0.5 * H - 0.5


def _border_terms(jx, jy, W: int, H: int, dtype):
    """Per-pixel mask/scale of the three prior modes: (inside the image,
    exponential std scale). The scale doubles every 12 px outside the image
    and is 0 beyond 100 px; it is computed in `dtype`."""
    inside = (jx >= 0) & (jx < W) & (jy >= 0) & (jy < H)
    zero = torch.zeros_like(jx)
    dx = torch.maximum(torch.maximum(-jx - 1, jx - W), zero)
    dy = torch.maximum(torch.maximum(-jy - 1, jy - H), zero)
    d = torch.maximum(dx, dy).to(dtype)
    within_pad = ((jx >= -_PAD) & (jx < W + _PAD) & (jy >= -_PAD)
                  & (jy < H + _PAD))
    return inside, torch.exp2(d / _DOUBLE_WIDTH) * within_pad.to(dtype)


def gather_priors(enc: SceneEncoding, uv):
    """(depth, std, normal) at the nearest pixels of uv (SB, NV, N, 2), in
    one packed (H, W, 5) gather: depth nearest/border, std nearest with
    exponential padding, normal nearest/zeros. Returns (depth (SB, NV, N),
    std (SB, NV, N), normal (SB, NV, N, 3))."""
    SB, NV, H, W, _ = enc.depths.shape
    N = uv.shape[-2]
    packed = torch.cat([enc.depths, enc.depth_stds, enc.normals], -1)
    flat = packed.reshape(SB * NV, H * W, 5)

    ix, iy = _pixel(uv, W, H)
    jx = torch.round(ix).to(torch.int32)
    jy = torch.round(iy).to(torch.int32)
    idx = (jy.clamp(0, H - 1) * W + jx.clamp(0, W - 1)).reshape(SB * NV, N)
    vals = torch.gather(flat, 1, idx.long()[..., None].expand(SB * NV, N, 5)
                        ).reshape(SB, NV, N, 5)

    inside, std_scale = _border_terms(jx, jy, W, H, vals.dtype)
    depth = vals[..., 0]
    std = vals[..., 1] * std_scale
    normal = vals[..., 2:5] * inside[..., None].to(vals.dtype)
    return depth, std, normal


def anchor_ids(uv, uv0, duv, dd, n_anchors: int):
    """Nearest-anchor ids (..., N) int32 of points uv (..., N, 2) on the
    chord (uv0 (..., 2), duv (..., 2), dd (...))."""
    t = ((uv - uv0[..., None, :]) * duv[..., None, :]).sum(-1)
    dd = dd[..., None]
    s = torch.where(dd > 1e-12, t / torch.where(dd == 0, torch.ones_like(dd),
                                                dd),
                    torch.full_like(t, 0.5))
    return (s.clamp(0.0, 1.0) * n_anchors).to(torch.int32).clamp(
        0, n_anchors - 1)


def _gather_anchor_priors(enc: SceneEncoding, uv0, duv, n_anchors: int):
    """Priors at `n_anchors` points spaced uniformly along each chord.
    Returns (depth, std (SB, NV, NR, A), normal (SB, NV, NR, A, 3))."""
    SB, NV, NR, _ = uv0.shape
    A = n_anchors
    frac = ((torch.arange(A, dtype=uv0.dtype, device=uv0.device) + 0.5)
            / A)[:, None]
    uv_anchor = uv0[..., None, :] + frac * duv[..., None, :]
    ad, astd, anrm = gather_priors(enc, uv_anchor.reshape(SB, NV, NR * A, 2))
    return (ad.reshape(SB, NV, NR, A), astd.reshape(SB, NV, NR, A),
            anrm.reshape(SB, NV, NR, A, 3))


def _gather_anchor_priors_paired(enc: SceneEncoding, uv0, duv,
                                 n_anchors: int):
    """Paired-anchor prior fetch: one row of a 2x2-packed bf16 prior table
    per two consecutive anchors; each anchor selects its own nearest pixel
    from the quad around the pair midpoint. Reproduces the JAX package's
    rounding: depth as a bf16 hi/lo pair, std and normal in bf16, the quad
    select in bf16 and the std scale in bf16. Same return layout as
    _gather_anchor_priors."""
    SB, NV, NR, _ = uv0.shape
    A = n_anchors
    if A % 2:
        raise ValueError("paired_prior_gather needs an even anchor count")
    P = A // 2
    H, W = enc.depths.shape[2:4]
    dev, dt = uv0.device, uv0.dtype
    bf16 = torch.bfloat16

    frac_mid = ((2.0 * torch.arange(P, dtype=dt, device=dev) + 1.0) / A)[:, None]
    frac_all = ((torch.arange(A, dtype=dt, device=dev) + 0.5) / A)[:, None]
    uv_mid = uv0[..., None, :] + frac_mid * duv[..., None, :]
    uv_all = uv0[..., None, :] + frac_all * duv[..., None, :]

    d32 = enc.depths.float()
    d_hi = d32.to(bf16)
    d_lo = (d32 - d_hi.float()).to(bf16)
    packed6 = torch.cat([d_hi, d_lo, enc.depth_stds.to(bf16),
                         enc.normals.to(bf16)], -1)       # (SB,NV,H,W,6)
    pq = torch.cat([packed6[:, :, :-1, :-1], packed6[:, :, :-1, 1:],
                    packed6[:, :, 1:, :-1], packed6[:, :, 1:, 1:]], -1)
    flat = pq.reshape(SB * NV, (H - 1) * (W - 1), 24)

    ix_m, iy_m = _pixel(uv_mid.reshape(SB, NV, NR * P, 2), W, H)
    x0 = torch.floor(ix_m).to(torch.int32).clamp(0, W - 2)
    y0 = torch.floor(iy_m).to(torch.int32).clamp(0, H - 2)
    idx = (y0 * (W - 1) + x0).reshape(SB * NV, NR * P)
    rows = torch.gather(flat, 1, idx.long()[..., None].expand(-1, -1, 24)
                        ).reshape(SB, NV, NR, P, 4, 6)

    ix, iy = _pixel(uv_all.reshape(SB, NV, NR * A, 2), W, H)
    jx = torch.round(ix).to(torch.int32)
    jy = torch.round(iy).to(torch.int32)
    jxc = jx.clamp(0, W - 1).reshape(SB, NV, NR, P, 2)
    jyc = jy.clamp(0, H - 1).reshape(SB, NV, NR, P, 2)
    sx = (jxc - x0.reshape(SB, NV, NR, P)[..., None]).clamp(0, 1)
    sy = (jyc - y0.reshape(SB, NV, NR, P)[..., None]).clamp(0, 1)
    q = (sy * 2 + sx)[..., None]                          # (SB,NV,NR,P,2,1)
    zero = torch.zeros((), dtype=bf16, device=dev)
    vals = sum(torch.where(q == k, rows[..., k, None, :], zero)
               for k in range(4)).reshape(SB, NV, NR, A, 6)

    inside, std_scale = _border_terms(jx.reshape(SB, NV, NR, A),
                                      jy.reshape(SB, NV, NR, A), W, H, bf16)
    depth = vals[..., 0].float() + vals[..., 1].float()
    std = vals[..., 2].float() * std_scale
    normal = vals[..., 3:6].float() * inside[..., None].float()
    return depth, std, normal


def _finish_likelihood(p, aux, return_aux: bool):
    """Max over views + occlusion transmittance, shared by both branches."""
    p = p.amax(dim=1)                                     # (SB, NR, NC)
    trans = torch.cumprod(1.0 - p, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    if return_aux:
        return p, p * trans, aux
    return p, p * trans


def surface_likelihoods(rays, z, enc: SceneEncoding, depth_diff_max: float,
                        prior_stride: int = 1, n_prior_anchors: int = 0,
                        paired_prior_gather: bool = False,
                        return_aux: bool = False, likelihood: str = "v1"):
    """Per-candidate surface likelihoods from the MVS depth priors.

    rays (SB, NR, 8); z (SB, NR, NC) distances along the unit ray dirs.
    likelihood: the anchor branch's route, "v1" (K1) or "chord" (K3; see
    RenderConfig.likelihood). Returns (p, opaque_p), each (SB, NR, NC), and
    with return_aux=True the EpiAnchors state (None unless anchors are on)
    as a third element.
    """
    SB, NR, NC = z.shape
    NV = enc.poses.shape[1]
    B = NR * NC
    s = prior_stride
    if NC % s:
        raise ValueError(f"prior_stride {s} does not divide {NC} candidates")
    if s > 1 and n_prior_anchors:
        raise ValueError("prior_stride and n_prior_anchors are mutually "
                         "exclusive")
    if likelihood not in LIKELIHOOD_ROUTES:
        raise ValueError(f"likelihood must be one of {LIKELIHOOD_ROUTES}, "
                         f"got {likelihood!r}")

    rot = enc.poses[..., :3, :3]                          # (SB, NV, 3, 3)
    dirs = rays[:, None, :, 3:6].expand(SB, NV, NR, 3)
    dirs_cam = dirs @ rot.transpose(-1, -2)               # (SB, NV, NR, 3)
    aux = None

    if n_prior_anchors:
        # closed form per (view, ray): the projection of o + z d is
        # rational-linear in z, so anchor ids and cam depths of all NC
        # candidates come from a few per-ray scalars
        A = n_prior_anchors
        o_cam = transform_points(enc.poses,
                                 rays[:, None, :, :3].expand(SB, NV, NR, 3))
        W, H = enc.image_shape
        wh = torch.tensor([W, H], dtype=rays.dtype, device=rays.device)
        f2 = (enc.focal * 2.0 / wh)[:, :, None]           # (SB, NV, 1, 2)
        cterm = (enc.c * 2.0 / wh - 1.0)[:, :, None]
        U0 = o_cam[..., :2] * f2 + o_cam[..., 2:3] * cterm
        U1 = dirs_cam[..., :2] * f2 + dirs_cam[..., 2:3] * cterm
        w0, w1 = o_cam[..., 2], dirs_cam[..., 2]          # (SB, NV, NR)

        z0, zL = z[:, None, :, 0], z[:, None, :, -1]      # (SB, 1, NR)
        den0, denL = w0 + z0 * w1, w0 + zL * w1
        # behind-camera guard: an endpoint with cam depth <= 0 has no valid
        # projection; sanitize the chord and gate p to 0 below
        chord_ok = (den0 > 1e-9) & (denL > 1e-9)

        def _endpoint(zz, den):
            safe = torch.where(den == 0, torch.ones_like(den), den)
            uv = (U0 + zz[..., None] * U1) / safe[..., None]
            return torch.where(chord_ok[..., None], uv, torch.zeros_like(uv))

        uv0 = _endpoint(z0, den0)
        duv = _endpoint(zL, denL) - uv0
        dd = (duv * duv).sum(-1)                          # (SB, NV, NR)
        P0 = ((U0 - w0[..., None] * uv0) * duv).sum(-1)
        P1 = ((U1 - w1[..., None] * uv0) * duv).sum(-1)

        if paired_prior_gather and A % 2 == 0:
            ad, astd, anrm = _gather_anchor_priors_paired(enc, uv0, duv, A)
        else:
            ad, astd, anrm = _gather_anchor_priors(enc, uv0, duv, A)
        aux = EpiAnchors(uv0=uv0, duv=duv, dd=dd, depth=ad)
        # the normal gate's cosine depends only on the anchor
        acos = (dirs_cam[:, :, :, None, :] * anrm).sum(-1)

        if likelihood == "chord":
            # K3 computes the ids and cam depths from these per-(view, ray)
            # scalars itself
            half_step = (rays[..., 7] - rays[..., 6]) / (2 * NC)  # (SB, NR)
            scal = torch.stack([
                w0, w1, P0, P1,
                1.0 / torch.where(dd == 0, torch.ones_like(dd), dd),
                (dd > 1e-12).to(rays.dtype), chord_ok.to(rays.dtype),
                half_step[:, None].expand(SB, NV, NR)], dim=-1)
            vals = torch.stack([ad, astd, acos], dim=3)   # (SB, NV, NR, 3, A)
            p = likelihood_from_chord(z.float(), scal.float(), vals.float(),
                                      A, depth_diff_max)
            return _finish_likelihood(p, aux, return_aux)

        z_nv = z[:, None]                                 # (SB, 1, NR, NC)
        z_cam = w0[..., None] + z_nv * w1[..., None]      # (SB, NV, NR, NC)
        front = chord_ok[..., None] & (z_cam > 1e-9)
        z_cam_safe = torch.where(z_cam.abs() > 1e-9, z_cam,
                                 torch.ones_like(z_cam))
        dd_safe = torch.where(dd == 0, torch.ones_like(dd), dd)
        t = (P0[..., None] + z_nv * P1[..., None]) \
            / (z_cam_safe * dd_safe[..., None])
        s_par = torch.where(dd[..., None] > 1e-12, t, torch.full_like(t, 0.5))
        a = (s_par.clamp(0.0, 1.0) * A).to(torch.int32).clamp(0, A - 1)

        G = SB * NV * NR
        vals = torch.stack([ad, astd, acos], dim=3).reshape(G, 3, A).float()
        half_step = (rays[..., 7] - rays[..., 6]) / (2 * NC)  # (SB, NR)
        half_step = half_step[:, None].expand(SB, NV, NR).reshape(G, 1)
        p = likelihood_from_anchors(a.reshape(G, NC), vals,
                                    z_cam.reshape(G, NC).contiguous(),
                                    half_step.contiguous(), depth_diff_max)
        p = torch.where(front, p.reshape(SB, NV, NR, NC), torch.zeros(
            (), dtype=p.dtype, device=p.device))
        return _finish_likelihood(p, aux, return_aux)

    xyz = rays[..., None, :3] + z[..., None] * rays[..., None, 3:6]
    xyz_nv = xyz.reshape(SB, 1, B, 3).expand(SB, NV, B, 3)
    xyz_cam = transform_points(enc.poses, xyz_nv)         # (SB, NV, B, 3)
    uv = project_points(xyz_cam, enc.focal, enc.c, enc.image_shape)
    z_cam = xyz_cam[..., 2].reshape(SB, NV, NR, NC)
    if s > 1:
        uv = uv.reshape(SB, NV, NR, NC, 2)[:, :, :, ::s]
        uv = uv.reshape(SB, NV, NR * (NC // s), 2)
    ref_depth, ref_std, ref_normal = gather_priors(enc, uv)
    if s > 1:
        def rep(x):
            x = x.reshape(SB, NV, NR, NC // s, *x.shape[3:])
            return x.repeat_interleave(s, dim=3)
        ref_depth, ref_std, ref_normal = (rep(ref_depth), rep(ref_std),
                                          rep(ref_normal))
    else:
        ref_depth = ref_depth.reshape(SB, NV, NR, NC)
        ref_std = ref_std.reshape(SB, NV, NR, NC)
        ref_normal = ref_normal.reshape(SB, NV, NR, NC, 3)
    cos = (dirs_cam[:, :, :, None, :] * ref_normal).sum(-1)

    step = ((rays[..., 7] - rays[..., 6]) / NC)[:, None, :, None]
    valid = ((cos <= 0) & ((ref_depth - z_cam).abs() < depth_diff_max)
             & (ref_std != 0))
    safe_std = torch.where(ref_std == 0, torch.ones_like(ref_std),
                           ref_std) * math.sqrt(2.0)
    hi = torch.erf((z_cam + step / 2 - ref_depth) / safe_std)
    lo = torch.erf((z_cam - step / 2 - ref_depth) / safe_std)
    p = torch.where(valid, 0.5 * (hi - lo).abs(), torch.zeros_like(hi))
    return _finish_likelihood(p, aux, return_aux)


def fill_uniform(z, rays, u=None, generator=None):
    """Refill empty (z == 0) slots stratified-uniformly over [near, far].

    z (SB, NR, K) with 0 marking empty; u (SB, NR, K) the uniform draw.
    After the ascending sort the empties sit in slots 0..n_missing-1; slot i
    gets near + (i + u) * (far - near) / n_missing. Returns (SB, NR, K)
    sorted ascending.
    """
    K = z.shape[-1]
    z = torch.sort(z, dim=-1).values
    missing = z == 0
    n_missing = missing.sum(-1, keepdim=True)
    near, far = rays[..., 6:7], rays[..., 7:8]
    step = (far - near) / n_missing.clamp(min=1).to(z.dtype)
    slot = torch.arange(K, dtype=z.dtype, device=z.device)
    if u is None:
        u = _uniform(z.shape, z, generator)
    z = torch.where(missing, near + (slot + u) * step, z)
    return torch.sort(z, dim=-1).values


def sample_depthguided(rays, enc: SceneEncoding, cfg: RenderConfig,
                       noise: Optional[tuple] = None, generator=None,
                       return_aux: bool = False):
    """Depth-guided sampling: rays (SB, NR, 8) -> z (SB, NR, n_samples),
    sorted ascending, and with return_aux=True the EpiAnchors state.

    noise: optional (u_strat (SB, NR, n_depth_candidates) uniform,
    g (SB, NR, n_gaussian) standard normal, u_fill (SB, NR, n_samples)
    uniform); any None entry, or noise=None, is drawn from `generator`.
    """
    if cfg.n_samples < cfg.n_gaussian:
        raise ValueError("n_samples must be >= n_gaussian")
    u_strat, g_noise, u_fill = noise if noise is not None else (None,) * 3

    z_cand = sample_stratified(rays, cfg.n_depth_candidates, u_strat,
                               generator)
    p, opaque, aux = surface_likelihoods(
        rays, z_cand, enc, cfg.depth_diff_max,
        prior_stride=cfg.prior_stride, n_prior_anchors=cfg.n_prior_anchors,
        paired_prior_gather=cfg.paired_prior_gather, return_aux=True,
        likelihood=cfg.likelihood)

    top_p, top_idx = torch.topk(p, cfg.n_samples, dim=-1)
    z_sel = torch.gather(z_cand, -1, top_idx)
    z_sel = torch.where(top_p == 0, torch.zeros_like(z_sel), z_sel)

    if cfg.n_gaussian > 0:
        hit = (opaque != 0).any(dim=-1, keepdim=True)
        mean, std = weighted_mean_and_std(z_cand, opaque, axis=-1,
                                          keepdims=True)
        if g_noise is None:
            g_noise = torch.randn((*z_sel.shape[:-1], cfg.n_gaussian),
                                  generator=generator, dtype=z_sel.dtype,
                                  device=z_sel.device)
        g = g_noise * std + mean
        # clamp into [near, far], with a lower bound > 0 so that a clamped
        # draw never equals the empty-slot marker 0
        lo = rays[..., None, 6].clamp(min=1e-6)
        g = torch.minimum(torch.maximum(g, lo), rays[..., None, 7])
        g = torch.where(hit, g, torch.zeros_like(g))
        z_sel = torch.cat([z_sel[..., : -cfg.n_gaussian], g], dim=-1)

    z_out = fill_uniform(z_sel, rays, u_fill, generator)
    if return_aux:
        return z_out, aux
    return z_out
