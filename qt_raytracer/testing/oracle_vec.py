"""Vectorized float64 oracle (sphere scenes AND mesh worlds, NEE included).

The scalar oracle (testing/oracle.py) is the semantic truth but runs Python
loops per (pixel, sample, bounce, sphere) — full-size validation is
unreachable
with it. This module is the SAME f64 math vectorized over rays with numpy:

  - the sphere loop runs in the scalar oracle's ITERATION ORDER with the
    identical running-best semantics (near-root best_t cap, far-root
    fallback, strict '<' tie-keep), vectorized over rays only; the triangle
    loop likewise mirrors oracle._hit_mesh_brute's order and caps;
  - elementwise formulas mirror the scalar helpers' operation order;
    measured agreement with the scalar oracle is ~1e-14 relative (f64
    reassociation noise from numpy's small-vector reductions — asserted at
    rtol 1e-12 in tests/test_oracle_vec.py), i.e. ~1e7x below the f32
    tolerances the oracle exists to check;
  - supports the full transport of BASELINE configs 1-4: all three
    materials + emissive-hit termination (MIS-weighted), NEE over the
    unified sphere+triangle light table, mesh worlds with per-face
    materials, and Russian roulette.

This makes "forward image allclose to a float64 oracle at equal spp/seed"
checkable at 256x256+ in seconds-to-minutes instead of hours
(benchmarks/run_baselines.py --oracle-full; tests/test_oracle_vec.py runs
the Cornell-mesh NEE config against it every round).
"""

from __future__ import annotations

import numpy as np

from ..core import sampling
from ..core.config import RenderConfig
from ..core.scene import DIELECTRIC, EMISSIVE, LAMBERTIAN, METAL
from .oracle import camera_to_np, mesh_to_np, scene_to_np

TWO_PI = 6.283185307179586
INV_PI = 1.0 / np.pi


def _dot(a, b):
    # (x + y) + z order == np.dot's sequential small-n accumulation.
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _unit(v):
    return v / np.sqrt(_dot(v, v))[..., None]


def _reflect(v, n):
    return v - (2.0 * _dot(v, n))[..., None] * n


def _hit_scene_vec(sc, o, d, t_min):
    """Vectorized-over-rays mirror of oracle._hit_scene (same sphere order,
    same running-best updates)."""
    n = o.shape[0]
    best_t = np.full(n, np.inf)
    best_i = np.full(n, -1, np.int64)
    a = _dot(d, d)
    for si in range(len(sc["radius"])):
        if not sc["active"][si]:
            continue
        oc = o - sc["center"][si]
        half_b = _dot(oc, d)
        c = _dot(oc, oc) - sc["radius"][si] * sc["radius"][si]
        disc = half_b * half_b - a * c
        with np.errstate(invalid="ignore", divide="ignore"):
            sqrtd = np.sqrt(np.maximum(disc, 0.0))
            q = -half_b - np.where(half_b >= 0.0, sqrtd, -sqrtd)
            root_a = q / a
            root_b = np.where(q == 0.0, 0.0, c / np.where(q == 0.0, 1.0, q))
        near = np.where(half_b >= 0.0, root_a, root_b)
        far = np.where(half_b >= 0.0, root_b, root_a)
        use_far = (near < t_min) | (near > best_t)
        root = np.where(use_far, far, near)
        reject = use_far & ((far < t_min) | (far > best_t))
        upd = (disc >= 0.0) & ~reject & (root < best_t)
        best_t = np.where(upd, root, best_t)
        best_i = np.where(upd, si, best_i)
    return best_t, best_i


def _hit_mesh_vec(me, o, d, t_min, t_max):
    """Vectorized-over-rays mirror of oracle._hit_mesh_brute (same triangle
    order, same per-ray t_max cap and strict running-best)."""
    n = o.shape[0]
    best_t = np.full(n, np.inf)
    best_i = np.full(n, -1, np.int64)
    v0s, e1s, e2s = me["v0"], me["e1"], me["e2"]
    with np.errstate(invalid="ignore", divide="ignore"):
        for fi in range(len(v0s)):
            e1, e2 = e1s[fi], e2s[fi]
            p = np.cross(d, e2[None, :])
            det = _dot(p, e1[None, :])
            ok = np.abs(det) > 1e-12
            inv_det = 1.0 / np.where(ok, det, 1.0)
            s = o - v0s[fi]
            u = _dot(s, p) * inv_det
            q = np.cross(s, e1[None, :])
            v = _dot(q, d) * inv_det
            t = _dot(q, e2[None, :]) * inv_det
            upd = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (t >= t_min) & (t <= t_max) & (t < best_t))
            best_t = np.where(upd, t, best_t)
            best_i = np.where(upd, fi, best_i)
    return best_t, best_i


def _onb_vec(w):
    """Vectorized oracle._onb (Duff et al., same branch-free form)."""
    sign = np.where(w[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + w[:, 2])
    b = w[:, 0] * w[:, 1] * a
    t1 = np.stack([1.0 + sign * w[:, 0] * w[:, 0] * a, sign * b,
                   -sign * w[:, 0]], axis=-1)
    t2 = np.stack([b, sign + w[:, 1] * w[:, 1] * a, -w[:, 1]], axis=-1)
    return t1, t2


def _sphere_pdf_vec(center, radius, from_p):
    """Vectorized oracle._sphere_pdf."""
    to_l = center - from_p
    dist2 = _dot(to_l, to_l)
    outside = dist2 > radius * radius * 1.0001
    sin2 = np.minimum(1.0, radius * radius / np.maximum(dist2, 1e-12))
    cos_max = np.sqrt(np.maximum(0.0, 1.0 - sin2))
    omc = sin2 / (1.0 + cos_max)
    ok = outside & (omc > 1e-12)
    pdf = np.where(ok, 1.0 / np.maximum(2.0 * np.pi * omc, 1e-30), 0.0)
    return pdf, ok, cos_max, to_l, dist2


def _nee_vec(sc, me, lt, p, normal, throughput, u, t_min, hit_albedo):
    """Vectorized oracle._nee_once over the unified light table lt
    (kind 0 = sphere, 1 = mesh face; world_lights order)."""
    n = p.shape[0]
    n_lights = lt["n"]
    pick = np.minimum((u[:, 4] * n_lights).astype(np.int64), n_lights - 1)
    kind = lt["kind"][pick]
    li = lt["idx"][pick]
    le = lt["emission"][pick]

    with np.errstate(invalid="ignore", divide="ignore"):
        # Sphere lights: solid-angle cone sample.
        pdf_s, ok_s, cos_max, to_l, dist2 = _sphere_pdf_vec(
            lt["center"][pick], lt["radius"][pick], p)
        w = to_l / np.sqrt(dist2)[:, None]
        cos_a = 1.0 - u[:, 5] * (1.0 - cos_max)
        sin_a = np.sqrt(np.maximum(0.0, 1.0 - cos_a * cos_a))
        phi = TWO_PI * u[:, 6]
        t1, t2 = _onb_vec(w)
        ldir_s = (sin_a * np.cos(phi))[:, None] * t1 \
            + (sin_a * np.sin(phi))[:, None] * t2 + cos_a[:, None] * w

        # Triangle lights: area sample (folded barycentrics).
        bu, bv = u[:, 5].copy(), u[:, 6].copy()
        fold = bu + bv > 1.0
        bu = np.where(fold, 1.0 - bu, bu)
        bv = np.where(fold, 1.0 - bv, bv)
        lv0, le1, le2 = lt["v0"][pick], lt["e1"][pick], lt["e2"][pick]
        p_l = lv0 + bu[:, None] * le1 + bv[:, None] * le2
        wv = p_l - p
        d2 = _dot(wv, wv)
        d2_ok = d2 > 1e-12
        ldir_t = wv / np.where(d2_ok, np.sqrt(d2), 1.0)[:, None]
        cr = np.cross(le1, le2)
        two_area = np.sqrt(_dot(cr, cr))
        area = 0.5 * two_area
        area_ok = area > 1e-20
        n_l = cr / np.where(area_ok, two_area, 1.0)[:, None]
        cos_l = np.abs(_dot(n_l, ldir_t))
        cos_ok = cos_l > 1e-7
        pdf_t = d2 / np.maximum(cos_l * area, 1e-30)
        ok_t = d2_ok & area_ok & cos_ok

    is_tri = kind == 1
    ldir = np.where(is_tri[:, None], ldir_t, ldir_s)
    pdf_j = np.where(is_tri, pdf_t, pdf_s)
    ok = np.where(is_tri, ok_t, ok_s)
    cos_surf = _dot(normal, ldir)
    cand = ok & (cos_surf > 0.0)

    # Shadow: the closest world hit must be exactly the chosen light.
    t_s, si = _hit_scene_vec(sc, p, ldir, t_min)
    cap = np.where(si >= 0, t_s, np.inf)
    if me is not None:
        t_m, fi = _hit_mesh_vec(me, p, ldir, t_min, cap)
        mesh_w = (fi >= 0) & (t_m < cap)
    else:
        fi = np.full(n, -1, np.int64)
        mesh_w = np.zeros(n, bool)
    win_kind = np.where(mesh_w, 1, 0)
    win_idx = np.where(mesh_w, fi, si)
    has_win = mesh_w | (si >= 0)
    lit = cand & has_win & (win_kind == kind) & (win_idx == li)

    pdf_nee = pdf_j / n_lights
    denom = pdf_nee + cos_surf * INV_PI
    factor = cos_surf * INV_PI / np.maximum(denom, 1e-30)
    contrib = throughput * hit_albedo * factor[:, None] * le
    return np.where(lit[:, None], contrib, 0.0)


def _emit_weight_vec(sc, me, p, o, si, fi, mesh_won, n_lights, prev_pdf):
    """Vectorized oracle._emit_weight_once."""
    with np.errstate(invalid="ignore", divide="ignore"):
        sii = np.maximum(si, 0)
        pdf_s, _, _, _, _ = _sphere_pdf_vec(sc["center"][sii],
                                            sc["radius"][sii], o)
        if me is not None:
            fii = np.maximum(fi, 0)
            wv = p - o
            d2 = _dot(wv, wv)
            e1, e2 = me["e1"][fii], me["e2"][fii]
            cr = np.cross(e1, e2)
            two_area = np.sqrt(_dot(cr, cr))
            area = 0.5 * two_area
            geom_ok = (d2 > 1e-12) & (area > 1e-20)
            ldir = wv / np.where(geom_ok, np.sqrt(d2), 1.0)[:, None]
            nl = cr / np.where(geom_ok, two_area, 1.0)[:, None]
            cos_l = np.abs(_dot(nl, ldir))
            pdf_t = np.where(geom_ok & (cos_l > 1e-7),
                             d2 / np.maximum(cos_l * area, 1e-30), 0.0)
            pdf_j = np.where(mesh_won, pdf_t, pdf_s)
        else:
            pdf_j = pdf_s
    pdf_nee = pdf_j / n_lights
    use = prev_pdf > 0.0
    return np.where(use, prev_pdf / np.where(use, prev_pdf + pdf_nee, 1.0),
                    1.0)


def _trace_vec(sc, o, d, bounce_u, max_depth, t_min, rr_start=0,
               me=None, lt=None, nee=False):
    """Vectorized mirror of oracle._trace_one (full transport: BSDF, NEE
    with MIS, mesh worlds)."""
    n = o.shape[0]
    nee_active = bool(nee) and lt is not None and lt["n"] > 0
    throughput = np.ones((n, 3))
    radiance = np.zeros((n, 3))
    alive = np.ones(n, bool)
    prev_pdf = np.full(n, -1.0)
    for b in range(max_depth):
        t, si = _hit_scene_vec(sc, o, d, t_min)
        if me is not None:
            cap = np.where(si >= 0, t, np.inf)
            t_m, fi = _hit_mesh_vec(me, o, d, t_min, cap)
            mesh_won = (fi >= 0) & (t_m < cap)
            t = np.where(mesh_won, t_m, t)
        else:
            fi = np.full(n, -1, np.int64)
            mesh_won = np.zeros(n, bool)
        miss = alive & (si < 0) & ~mesh_won
        sky_u = _unit(d)
        sky_t = 0.5 * (sky_u[:, 1] + 1.0)
        sky = ((1.0 - sky_t)[:, None] * np.array([1.0, 1.0, 1.0])
               + sky_t[:, None] * np.array([0.5, 0.7, 1.0]))
        radiance = np.where(miss[:, None], radiance + throughput * sky,
                            radiance)
        alive = alive & ((si >= 0) | mesh_won)
        sii = np.maximum(si, 0)
        with np.errstate(invalid="ignore"):
            p = o + t[:, None] * d
        p = np.where(alive[:, None], p, o)

        center = sc["center"][sii]
        radius = sc["radius"][sii]
        outward = (p - center) / radius[:, None]
        front_face = _dot(d, outward) < 0.0
        normal = np.where(front_face[:, None], outward, -outward)
        mat = sc["mat_type"][sii]
        albedo = sc["albedo"][sii]
        fuzz = sc["fuzz"][sii]
        ior_v = sc["ior"][sii]
        emission = sc["emission"][sii]
        if me is not None:
            fii = np.maximum(fi, 0)
            gn = me["geom_normal"][fii]
            ff_m = _dot(d, gn) < 0.0
            nrm_m = np.where(ff_m[:, None], gn, -gn)
            mw = mesh_won
            front_face = np.where(mw, ff_m, front_face)
            normal = np.where(mw[:, None], nrm_m, normal)
            mat = np.where(mw, me["mat_type"][fii], mat)
            albedo = np.where(mw[:, None], me["albedo"][fii], albedo)
            fuzz = np.where(mw, me["fuzz"][fii], fuzz)
            ior_v = np.where(mw, me["ior"][fii], ior_v)
            emission = np.where(mw[:, None], me["emission"][fii], emission)
        u = bounce_u[:, b, :]

        # Lambertian (oracle._unit_vector_sample + degenerate guard).
        z = 1.0 - 2.0 * u[:, 0]
        r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
        phi = TWO_PI * u[:, 1]
        uv = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)
        nd_lam = normal + uv
        nd_lam = np.where((_dot(nd_lam, nd_lam) < 1e-8)[:, None],
                          normal, nd_lam)

        # Metal.
        ud = _unit(d)
        refl = _reflect(ud, normal)
        nd_met = refl + fuzz[:, None] * (uv * np.cbrt(u[:, 2])[:, None])
        met_absorb = _dot(nd_met, normal) <= 0.0

        # Dielectric.
        ratio = np.where(front_face, 1.0 / ior_v, ior_v)
        cos_theta = np.minimum(_dot(-ud, normal), 1.0)
        sin_theta = np.sqrt(np.maximum(0.0, 1.0 - cos_theta * cos_theta))
        cannot = ratio * sin_theta > 1.0
        r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
        refl_p = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
        must_reflect = cannot | (refl_p > u[:, 3])
        r_perp = ratio[:, None] * (ud + cos_theta[:, None] * normal)
        r_par = -np.sqrt(np.abs(1.0 - _dot(r_perp, r_perp)))[:, None] * normal
        nd_die = np.where(must_reflect[:, None], _reflect(ud, normal),
                          r_perp + r_par)

        is_lam = mat == LAMBERTIAN
        is_met = mat == METAL
        is_die = mat == DIELECTRIC
        is_emit = mat == EMISSIVE

        emit_now = alive & is_emit
        if nee_active:
            emit_w = _emit_weight_vec(sc, me, p, o, si, fi, mesh_won,
                                      lt["n"], prev_pdf)
        else:
            emit_w = np.ones(n)
        radiance = np.where(emit_now[:, None],
                            radiance + throughput * emission
                            * emit_w[:, None], radiance)

        if nee_active:
            nee_c = _nee_vec(sc, me, lt, p, normal, throughput, u, t_min,
                             albedo)
            radiance = np.where((alive & is_lam)[:, None],
                                radiance + nee_c, radiance)

        nd = np.where(is_lam[:, None], nd_lam,
                      np.where(is_met[:, None], nd_met, nd_die))
        att = np.where((is_die | is_emit)[:, None], 1.0, albedo)
        continues = alive & ~is_emit & ~(is_met & met_absorb)
        throughput = np.where(continues[:, None], throughput * att,
                              throughput)
        o = np.where(continues[:, None], p, o)
        d = np.where(continues[:, None], nd, d)
        if nee_active:
            with np.errstate(invalid="ignore", divide="ignore"):
                ndu = nd / np.sqrt(np.maximum(_dot(nd, nd), 1e-300))[:, None]
            pdf_next = np.where(is_lam,
                                np.maximum(_dot(normal, ndu), 0.0) * INV_PI,
                                -1.0)
            prev_pdf = np.where(continues, pdf_next, prev_pdf)
        alive = continues
        if rr_start > 0 and b >= rr_start:
            p_cont = np.clip(np.max(throughput, axis=-1), 0.05, 1.0)
            survive = u[:, 7] < p_cont
            kill = alive & ~survive
            adj = alive & survive
            throughput = np.where(adj[:, None], throughput / p_cont[:, None],
                                  throughput)
            alive = alive & ~kill
        if not alive.any():
            break
    return radiance


def _light_table_np(scene, me):
    """Unified f64 light table in world_lights order (spheres first).
    Sphere rows carry center/radius; triangle rows carry v0/e1/e2."""
    kinds, idxs = [], []
    for i in np.asarray(scene.light_idx):
        kinds.append(0)
        idxs.append(int(i))
    if me is not None:
        for f in me["light_tri"]:
            kinds.append(1)
            idxs.append(int(f))
    L = len(kinds)
    lt = {"n": L, "kind": np.array(kinds, np.int64),
          "idx": np.array(idxs, np.int64),
          "center": np.zeros((max(L, 1), 3)),
          "radius": np.ones(max(L, 1)),
          "v0": np.zeros((max(L, 1), 3)), "e1": np.zeros((max(L, 1), 3)),
          "e2": np.zeros((max(L, 1), 3)),
          "emission": np.zeros((max(L, 1), 3))}
    sc = scene_to_np(scene)
    for row, (k, i) in enumerate(zip(kinds, idxs)):
        if k == 0:
            lt["center"][row] = sc["center"][i]
            lt["radius"][row] = sc["radius"][i]
            lt["emission"][row] = sc["emission"][i]
        else:
            lt["v0"][row] = me["v0"][i]
            lt["e1"][row] = me["e1"][i]
            lt["e2"][row] = me["e2"][i]
            lt["emission"][row] = me["emission"][i]
    return lt


def render_oracle_vec(scene, camera, cfg: RenderConfig, key,
                      ray_chunk: int = 32768) -> np.ndarray:
    """Sum of spp f64 radiance samples, [H, W, 3] — vectorized oracle.
    Accepts SphereScene or World (mesh + NEE supported)."""
    me = None
    if hasattr(scene, "spheres"):
        if scene.mesh is not None:
            me = mesh_to_np(scene.mesh)
        scene = scene.spheres
    lt = _light_table_np(scene, me) if cfg.nee else None
    sc = scene_to_np(scene)
    cam = camera_to_np(camera)
    import jax.numpy as jnp

    h, w = cfg.height, cfg.width
    n = h * w
    inv_w = 1.0 / max(w - 1, 1)
    inv_h = 1.0 / max(h - 1, 1)
    px = np.arange(n) % w
    jj = (h - 1) - np.arange(n) // w
    pix_keys = sampling.pixel_states(key, jnp.arange(n, dtype=jnp.uint32),
                                     cfg.rng)
    out = np.zeros((n, 3))
    for s in range(cfg.spp):
        samp_keys = sampling.sample_keys(pix_keys, s)
        gen = np.asarray(sampling.stream_uniforms(
            samp_keys, sampling.STREAM_GEN, sampling.UNIFORMS_GEN),
            np.float64)
        bounce = np.stack([
            np.asarray(sampling.stream_uniforms(
                samp_keys, sampling.STREAM_BOUNCE0 + b,
                sampling.UNIFORMS_PER_BOUNCE), np.float64)
            for b in range(cfg.max_depth)], axis=1)        # [N, depth, 8]
        u_coord = (px + gen[:, 0]) * inv_w
        v_coord = (jj + gen[:, 1]) * inv_h
        # oracle._in_unit_disk_sample, vectorized.
        dr = np.sqrt(gen[:, 2])
        dphi = TWO_PI * gen[:, 3]
        rd = cam["lens_radius"] * np.stack(
            [dr * np.cos(dphi), dr * np.sin(dphi)], axis=-1)
        offset = rd[:, 0:1] * cam["u"] + rd[:, 1:2] * cam["v"]
        o = cam["origin"] + offset
        d = (cam["lower_left_corner"] + u_coord[:, None] * cam["horizontal"]
             + v_coord[:, None] * cam["vertical"] - cam["origin"] - offset)
        for lo in range(0, n, ray_chunk):
            hi_ = min(lo + ray_chunk, n)
            out[lo:hi_] += _trace_vec(sc, o[lo:hi_], d[lo:hi_],
                                      bounce[lo:hi_], cfg.max_depth,
                                      cfg.t_min, rr_start=cfg.rr_start,
                                      me=me, lt=lt, nee=cfg.nee)
    return out.reshape(h, w, 3)
