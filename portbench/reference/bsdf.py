"""The benchmark's frozen copy of the port's plain GGX + Lambert BSDF
(rsoderh_raytracing_tpu_torch/ops/bsdf.py; originally the kernel-side BSDF of
rsoderh_raytracing_tpu/ops/pallas_wavefront.py:87-313).

``trace_epilogue`` joins the material parameters, the NEE eval/pdf and the
bounce sample as every integrator of the port takes them after a hit.

Vectors are 3-tuples of (n,) tensors. Every expression keeps the
reference's operand order, so float results differ from it only where
the backends round a transcendental or contract an FMA differently.
The RNG state is int64 holding u32 values (ops/rng.py).
"""

from __future__ import annotations

import torch

from portbench.reference import rng

PI = rng.PI_DEVICE
DIELECTRIC_F0 = 0.04


def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def vwhere(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vnorm_maxeps(a):
    return torch.clamp_min(torch.sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]), 1.0e-20)


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def lum(c):
    return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]


def power_heuristic(pdf_a, pdf_b):
    """beta=2 power heuristic with the reference's denominator guard."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return a2 / torch.clamp_min(a2 + b2, 1.0e-30)


def make_frame(n):
    """(tangent, bitangent, normal) of a normal (shader.wgsl:49-84)."""
    use_z = torch.abs(n[2]) < 0.999
    zero = torch.zeros_like(n[0])
    helper = (torch.where(use_z, 0.0, 1.0), zero, torch.where(use_z, 1.0, 0.0))
    t = vcross(helper, n)
    t = vscale(t, 1.0 / vnorm_maxeps(t))
    b = vcross(n, t)
    return t, b, n


def to_local(frame, v):
    t, b, n = frame
    return (vdot(v, t), vdot(v, b), vdot(v, n))


def to_world(frame, v):
    t, b, n = frame
    w = (
        t[0] * v[0] + b[0] * v[1] + n[0] * v[2],
        t[1] * v[0] + b[1] * v[1] + n[1] * v[2],
        t[2] * v[0] + b[2] * v[1] + n[2] * v[2],
    )
    return vscale(w, 1.0 / vnorm_maxeps(w))


def d_ggx(ndh, alpha):
    a2 = alpha * alpha
    denom = ndh * ndh * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def g1_ggx(ndv, alpha):
    ndv2 = ndv * ndv
    lam = (
        torch.sqrt(1.0 + alpha * alpha * (1.0 - ndv2) / torch.clamp_min(ndv2, 1e-20))
        - 1.0
    ) / 2.0
    return 1.0 / (1.0 + lam)


def surface_kd(color, metallic, f0):
    kd0_s = 1.0 - saturate(metallic)
    fmax_s = 1.0 - torch.maximum(f0[0], torch.maximum(f0[1], f0[2]))
    return tuple((color[i] * kd0_s) * fmax_s for i in range(3))


def bsdf_eval(wo, wi, color, metallic, alpha, f0):
    """f(wo, wi) in the shading frame."""
    ndo, ndi = wo[2], wi[2]
    valid = (ndo > 0.0) & (ndi > 0.0)
    h = (wo[0] + wi[0], wo[1] + wi[1], wo[2] + wi[2])
    h = vscale(h, 1.0 / vnorm_maxeps(h))
    ndh = saturate(h[2])
    d = d_ggx(ndh, alpha)
    g = g1_ggx(ndo, alpha) * g1_ggx(ndi, alpha)
    x = 1.0 - saturate(vdot(h, wo))
    x2 = x * x
    x5 = x2 * x2 * x
    fr = tuple(f0[i] + (1.0 - f0[i]) * x5 for i in range(3))
    denom = 4.0 * ndo * ndi
    fs_s = d * g / torch.where(valid, denom, 1.0)
    kd = surface_kd(color, metallic, f0)
    inv_pi = 1.0 / PI
    return tuple(
        torch.where(valid, kd[i] * inv_pi + fs_s * fr[i], 0.0) for i in range(3)
    )


def bsdf_pdf(wo, wi, f0, alpha):
    spec_p = saturate(lum(f0))
    diff_p = 1.0 - spec_p
    h = (wo[0] + wi[0], wo[1] + wi[1], wo[2] + wi[2])
    h = vscale(h, 1.0 / vnorm_maxeps(h))
    wo_dot_h = torch.abs(vdot(wo, h))
    ndh = h[2]
    pdf_half = (
        d_ggx(ndh, alpha)
        * g1_ggx(wo[2], alpha)
        * torch.clamp_min(vdot(wo, h), 0.0)
        / torch.where(wo[2] == 0.0, 1.0, wo[2])
    )
    pdf_half = torch.where(ndh <= 0.0, 0.0, pdf_half)
    pdf_spec = pdf_half / torch.clamp_min(4.0 * wo_dot_h, 1.0e-20)
    pdf_spec = torch.where(wo_dot_h <= 0.0, 0.0, pdf_spec)
    pdf_cos = torch.where(wi[2] <= 0.0, 0.0, wi[2] / PI)
    pdf = diff_p * pdf_cos + spec_p * pdf_spec
    return torch.where((wo[2] > 0.0) & (wi[2] > 0.0), pdf, 0.0)


def bsdf_sample(state, rd, n, color, metallic, alpha, f0):
    """Bounce sample with the reference's colored error sentinels.
    Returns (state, direction, scattering, pdf, zero_direction)."""
    wo_world = (-rd[0], -rd[1], -rd[2])
    bail_a = vdot(n, wo_world) <= 0.0
    frame = make_frame(n)
    wo = to_local(frame, wo_world)
    bail_b = wo[2] <= 0.0

    spec_p = saturate(lum(f0))
    diff_p = 1.0 - spec_p
    state, u1 = rng.next_uniform(state)
    state, u2 = rng.next_uniform(state)

    # diffuse candidate (cosine hemisphere, u1 rescaled)
    du = u1 / torch.clamp_min(diff_p, 1.0e-6)
    r_d = torch.sqrt(du)
    phi_d = 2.0 * PI * u2
    dxl = r_d * torch.cos(phi_d)
    dyl = r_d * torch.sin(phi_d)
    dzl = torch.sqrt(torch.clamp_min(1.0 - dxl * dxl - dyl * dyl, 0.0))
    wi_diff = (dxl, dyl, dzl)

    # specular candidate (GGX VNDF)
    su = (u1 - diff_p) / torch.clamp_min(spec_p, 1.0e-6)
    view = (wo[0] * alpha, wo[1] * alpha, wo[2])
    view = vscale(view, 1.0 / vnorm_maxeps(view))
    len_sq = view[0] * view[0] + view[1] * view[1]
    # The reference's rsqrt, written as 1/sqrt like the CUDA kernel.
    inv_len = 1.0 / torch.sqrt(torch.clamp_min(len_sq, 1.0e-20))
    has_len = len_sq > 0.0
    tx = (
        torch.where(has_len, -view[1] * inv_len, 1.0),
        torch.where(has_len, view[0] * inv_len, 0.0),
        torch.zeros_like(view[0]),
    )
    ty = vcross(view, tx)
    radius = torch.sqrt(su)
    az = 2.0 * PI * u2
    dska = radius * torch.cos(az)
    dskb_raw = radius * torch.sin(az)
    dskb = (1.0 - view[2]) * torch.sqrt(
        torch.clamp_min(1.0 - dska * dska, 0.0)
    ) + view[2] * dskb_raw
    hz = torch.sqrt(torch.clamp_min(1.0 - dska * dska - dskb * dskb, 0.0))
    hst = tuple(dska * tx[i] + dskb * ty[i] + hz * view[i] for i in range(3))
    h = (hst[0] * alpha, hst[1] * alpha, torch.clamp_min(hst[2], 0.0))
    h = vscale(h, 1.0 / vnorm_maxeps(h))
    wo_dot_h2 = 2.0 * vdot(wo, h)
    wi_spec = tuple(wo_dot_h2 * h[i] - wo[i] for i in range(3))

    choose_diffuse = u1 < diff_p
    wi = vwhere(choose_diffuse, wi_diff, wi_spec)
    spec_fail = (~choose_diffuse) & (wi_spec[2] <= 0.0)

    scattering = bsdf_eval(wo, wi, color, metallic, alpha, f0)
    pdf = bsdf_pdf(wo, wi, f0, alpha)
    wi_world = to_world(frame, wi)
    bail_c = vdot(n, wi_world) < 0.0

    zero = torch.zeros_like(wi_world[0])
    one = torch.ones_like(wi_world[0])
    red = (one, zero, zero)
    green = (zero, one, zero)
    blue = (zero, zero, one)
    zero3 = (zero, zero, zero)

    direction = vwhere(bail_c, zero3, wi_world)
    direction = vwhere(spec_fail, red, direction)
    direction = vwhere(bail_a | bail_b, zero3, direction)

    scattering = vwhere(bail_c, green, scattering)
    scattering = vwhere(spec_fail, red, scattering)
    scattering = vwhere(bail_b, green, scattering)
    scattering = vwhere(bail_a, blue, scattering)

    any_bail = bail_a | bail_b | bail_c | spec_fail
    pdf = torch.where(any_bail, 0.0, pdf)
    zero_direction = bail_a | bail_b | (bail_c & ~spec_fail)
    return state, direction, scattering, pdf, zero_direction


def trace_epilogue(rd, nee_dir, normal, color, rough, metal, state):
    """Material parameters, the NEE BSDF eval/pdf and the bounce sample
    (pallas_wavefront.trace_epilogue). ``state`` is int64. Returns
    (cos_theta, nee_scatter, nee_pdf_b, state, bdir, bscat, bpdf, bzero,
    cos_bounce)."""
    alpha = torch.clamp_min(rough * rough, 0.001)
    msat = saturate(metal)
    f0 = tuple(
        DIELECTRIC_F0 + (color[i] - DIELECTRIC_F0) * msat
        for i in range(3)
    )
    cos_theta = torch.clamp_min(vdot(normal, nee_dir), 0.0)
    frame = make_frame(normal)
    wo = to_local(frame, (-rd[0], -rd[1], -rd[2]))
    wi = to_local(frame, nee_dir)
    nee_scatter = bsdf_eval(wo, wi, color, metal, alpha, f0)
    nee_pdf_b = bsdf_pdf(wo, wi, f0, alpha)
    state, bdir, bscat, bpdf, bzero = bsdf_sample(
        state, rd, normal, color, metal, alpha, f0
    )
    cos_bounce = torch.clamp_min(vdot(normal, bdir), 0.0)
    return (
        cos_theta, nee_scatter, nee_pdf_b, state, bdir, bscat, bpdf,
        bzero, cos_bounce,
    )
