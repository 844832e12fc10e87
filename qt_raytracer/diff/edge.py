"""Edge-aware (silhouette) gradients: screen-space boundary estimator.

The detached-decision pathwise estimator (diff/inverse.py) holds every
discrete decision fixed, so the derivative of the HIT INDICATOR — the Dirac
term living on silhouette edges — is dropped by construction. That term is
what moves object and camera parameters across visibility boundaries; without
it, camera-translation gradients see only interior shading and BASELINE
config 5's camera recovery is crippled.

The boundary integral (differentiable-rendering boundary term; Li et al.
2018 edge sampling / Bangaru et al. 2020 warped-area form, re-derived here
for sphere silhouettes where everything is closed-form):

    d/dθ ∫ L dA  ⊇  ∮_edges (L_fg − L_bg) · v_n  dl

where v_n is the normal velocity of the silhouette curve in the image plane
under dθ. For a sphere, the hit indicator is H(g) with the closed-form

    g(ray, c, r) = r² − ρ²,   ρ = perpendicular distance of center to ray

positive inside the silhouette, zero exactly on it. Divide by the
screen-space gradient magnitude |∇_px g| (detached) and g becomes a signed
distance sd in PIXEL units; primary samples with 0 < sd ≤ W lie within W
pixels inside the edge. A one-sided kernel w(sd) with unit integral turns
those samples into an unbiased-as-W→0 Monte-Carlo estimate of the edge
integral (W = 1 px; the optional SECOND-ORDER weight — see _edge_weight —
additionally cancels the O(W) velocity-blur bias, measured linear in W by
benchmarks/tri_edge_bias.py):

    edge ≈ Σ_samples  w(sd) · (L_fg − L_bg) · ∂sd/∂θ

L_bg ("what would this ray see if the winning sphere were absent") comes
from ONE extra trace with the bounce-0 winner excluded
(integrator.trace(exclude_prim0=...)) on the SAME RNG stream, so the
difference is tightly correlated. The whole term is added to the sample
radiance in the primal-zero autodiff form

    w_detached · stopgrad(L_fg − L_bg) · (sd − stopgrad(sd))

which is exactly 0.0 in the forward pass (images, oracle goldens and
progressive accumulation are untouched) while its VJP contributes
w · ΔL · ∂sd/∂θ. Scope: PRIMARY-ray silhouettes of BOTH primitive
families — spheres (g above) and mesh triangles, where the interior
function is the barycentric edge margin

    g_tri(ray, v0, e1, e2) = min(u, v, 1 − u − v)

(positive strictly inside the winning triangle, zero exactly on its
boundary). The same |∇_px g| normalization turns it into pixel units. The
background re-trace excludes only the WINNING triangle, which makes the
estimator self-selecting: at an interior (shared) edge the neighbor
triangle catches the excluded ray, so L_fg − L_bg ≈ 0 and the term
vanishes; at a true visibility boundary (object silhouette, or a convex
crease where the winner flips between faces) the re-trace reveals the
occluded geometry and the jump is exactly the discontinuity the detached
estimator dropped.

Round 4 adds the FIRST-VERTEX NEE SHADOW-EDGE term (the in-function block
below): the pathwise estimator also detaches the shadow ray's visibility,
dropping the gradient of shadows sweeping across receivers. The same
screen-space machinery applies — the shadow boundary on the receiver is a
curve in image space, parameterized by the BLOCKER's interior margin along
the mirrored NEE shadow ray through the differentiably re-derived hit
point x1(i, j). FD-validated in isolation (tests/test_shadow_edge.py: 93%
capture of a pure shadow-sweep gradient that plain pathwise and the
silhouette-only term both put at exactly 0). Shadow/silhouette
discontinuities at vertex 2+ (seen via a bounce) remain unmodeled. On the
enclosed Cornell at 48x32 the round-5 W-sweep
(benchmarks/adaptive_w_probe.py) measured capture FLAT in the kernel
width within key noise (41-45% of an FD whose own key spread is ~17%),
refuting round 4's attribution of the residual to kernel-width bias at
the tiny ceiling light: whatever is missing there is not W-mediated —
the unmodeled vertex-2+ boundary terms and FD reference noise carry it
(ledger entry "Round-5 adaptive-W refutation"). Pose recovery converges
regardless (tests/test_mesh_edge_gradients.py, config 5).

No reference counterpart (the reference is forward-only).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import camera as cam_mod
from ..core import sampling
from ..core import vecmath as vm
from ..core.config import RenderConfig
from ..core.integrator import trace
from ..core.world import as_world, intersect_world

# One-sided kernel width in pixel units.
EDGE_KERNEL_PX = 1.0
# Kernel order (QTRT_EDGE_KERNEL_ORDER): 1 (default) = the one-sided
# triangular weight; 2 = the Richardson-extrapolated weight 2*w_{W/2} -
# w_W, which CANCELS the O(W) kernel bias at zero extra trace cost (the
# background re-trace is shared; only the weight polynomial changes).
# Measured (benchmarks/tri_edge_bias.py, quad coverage functional,
# 256 spp, FD truth -0.0220+-0.0005 stable over eps 5e-3..4e-2):
#   order 1: linear-in-W bias, ~13%/px at a 14-px feature scale
#            (-0.0202 / -0.0187 / -0.0159 at W = 0.5/1/2), W->0
#            extrapolation 98% of FD. The bias scales as
#            W / feature-size-in-px (a velocity blur), so ~1-3% at
#            production resolutions — and for training it only rescales
#            the gradient, which the lr absorbs.
#   order 2: W-independent, within ~1-3% of FD at every W
#            (-0.0218 / -0.0217 / -0.0214) — but the signed weight has
#            ~3x the peak magnitude, so more gradient variance per
#            sample; kept opt-in for validation/accuracy-critical use.
# tests/test_mesh_edge_gradients.py pins both: the order-1 bias band and
# the order-2 FD match at rtol 0.1.
import os as _os

EDGE_KERNEL_ORDER = int(_os.environ.get("QTRT_EDGE_KERNEL_ORDER", "1"))


def _kernel_width() -> float:
    """Effective kernel width W in pixels, resolved at TRACE time:
    QTRT_EDGE_KERNEL_PX if set, else the module global. The round-5 W-sweep
    (benchmarks/adaptive_w_probe.py) measured capture on the small-feature
    Cornell case nearly flat in W (the premise of feature-scale-adaptive W
    — see the ledger), so W stays a global knob: 1.0 default, 0.5 with
    order 2 is the accuracy-leaning setting; below ~0.5 px the estimator
    is variance-limited at practical spp."""
    v = _os.environ.get("QTRT_EDGE_KERNEL_PX")
    return float(v) if v is not None else EDGE_KERNEL_PX


def _kernel_order() -> int:
    """Effective kernel order, resolved at TRACE time (like
    QTRT_EDGE_SHADOW): the env var wins if set, else the module global
    (which tests may mutate directly). Changing either after a graph is
    compiled still needs jax.clear_caches() — the order is baked into the
    traced weight polynomial."""
    v = _os.environ.get("QTRT_EDGE_KERNEL_ORDER")
    return int(v) if v is not None else EDGE_KERNEL_ORDER


def _edge_weight(sd_det, w_px: float, order: int):
    """Unit-integral one-sided kernel weight on (0, w_px].

    order 1: w(s) = (2/W)(1 - s/W)              (first moment W/3)
    order 2: 2*w_{W/2}(s)*[s<=W/2] - w_W(s)     (first moment 0)
    """
    tri = lambda wd: (2.0 / wd) * (1.0 - sd_det / wd)
    if order == 1:
        return tri(w_px)
    half = 0.5 * w_px
    inner = jnp.where(sd_det <= half, 2.0 * tri(half), 0.0)
    return inner - tri(w_px)


def _silhouette_g(origins, directions, centers, radii):
    """g = r² − ρ² (ρ = perpendicular distance of the sphere center from the
    ray line): positive strictly inside the silhouette cone, 0 on it."""
    oc = centers - origins
    d2 = vm.length_squared(directions)
    inv_d = jnp.where(d2 > 1e-20, 1.0 / vm.safe_sqrt(d2), 0.0)
    along = vm.dot(oc, directions) * inv_d
    perp2 = jnp.maximum(vm.length_squared(oc) - along * along, 0.0)
    return radii * radii - perp2


def _tri_interior_g(origins, directions, v0, e1, e2):
    """Barycentric edge margin of the ray/triangle-plane intersection:
    min(u, v, 1−u−v), positive strictly inside the (per-ray gathered)
    winning triangle and 0 exactly on its boundary. Differentiable in the
    ray (camera params via rays_of) AND the vertices (geometry recovery).
    Same Möller-Trumbore u/v recipe as accel/traverse._tri_hit_one."""
    p = jnp.cross(directions, e2)
    det = jnp.sum(p * e1, axis=-1)
    ok = jnp.abs(det) > 1e-12
    inv_det = jnp.where(ok, 1.0, 0.0) / jnp.where(ok, det, 1.0)
    s = origins - v0
    u = jnp.sum(s * p, axis=-1) * inv_det
    q = jnp.cross(s, e1)
    v = jnp.sum(q * directions, axis=-1) * inv_det
    return jnp.minimum(jnp.minimum(u, v), 1.0 - u - v)


def sample_radiance_edge_aware(scene, camera, cfg: RenderConfig,
                               pix_keys, i, j, sample_idx):
    """_sample_radiance plus the silhouette boundary term (primal-zero).

    Same RNG contract as core/render._sample_radiance: identical streams,
    identical forward radiance.
    """
    world = as_world(scene)
    ns = world.spheres.num_spheres
    samp_keys = sampling.sample_keys(pix_keys, sample_idx)
    gen = sampling.stream_uniforms(samp_keys, sampling.STREAM_GEN,
                                   sampling.UNIFORMS_GEN)
    inv_w = 1.0 / max(cfg.width - 1, 1)
    inv_h = 1.0 / max(cfg.height - 1, 1)

    def rays_of(i_f, j_f):
        s = (i_f + gen[:, 0]) * inv_w
        t = (j_f + gen[:, 1]) * inv_h
        return cam_mod.get_rays(camera, s, t, gen[:, 2], gen[:, 3])

    origins, directions = rays_of(i, j)
    o_sg = jax.lax.stop_gradient(origins)
    d_sg = jax.lax.stop_gradient(directions)

    # ALL THREE traces share one intersector so bounce-0 winner selection is
    # self-consistent; the kernels carry the per-lane exclusion operands the
    # background re-trace needs.
    from ..core.render import resolve_intersector

    wb = resolve_intersector(cfg)
    l_full = trace(world, origins, directions, samp_keys, cfg.max_depth,
                   cfg.t_min, intersector=wb, nee=cfg.nee,
                   rr_start=cfg.rr_start)

    # Bounce-0 winner (detached: selection only).
    h0 = intersect_world(world, o_sg, d_sg, cfg.t_min, backend=wb)
    prim0 = h0.prim_idx
    is_sph = h0.hit & (h0.prim_idx < ns) & h0.front_face
    is_tri = h0.hit & (h0.prim_idx >= ns) & h0.front_face
    if ns:
        widx = jnp.clip(h0.prim_idx, 0, ns - 1)
        centers = world.spheres.center[widx]      # differentiable gathers
        radii = world.spheres.radius[widx]
    hit0 = h0.hit
    p0_det = jax.lax.stop_gradient(h0.point)
    n0_det = jax.lax.stop_gradient(h0.normal)
    alb0_det = jax.lax.stop_gradient(h0.albedo)
    diffuse0 = h0.hit & (h0.mat_type == 0)        # LAMBERTIAN == 0

    if world.mesh is not None:
        nt = world.mesh.num_triangles
        tidx = jnp.clip(prim0 - ns, 0, nt - 1)
        tv0 = world.mesh.v0[tidx]                 # differentiable gathers
        te1 = world.mesh.e1[tidx]
        te2 = world.mesh.e2[tidx]
    is_tri_det = jax.lax.stop_gradient(is_tri)

    # Signed distance to the winner's silhouette in pixel units (family-
    # selected: sphere cone margin or triangle barycentric edge margin).
    def g_of(i_f, j_f):
        o, d = rays_of(i_f, j_f)
        g = (_silhouette_g(o, d, centers, radii) if ns
             else jnp.full(i_f.shape, -1.0))
        if world.mesh is not None:
            g = jnp.where(is_tri_det, _tri_interior_g(o, d, tv0, te1, te2),
                          g)
        return g

    g = g_of(i, j)
    _, gi = jax.jvp(lambda x: g_of(x, j), (i,), (jnp.ones_like(i),))
    _, gj = jax.jvp(lambda y: g_of(i, y), (j,), (jnp.ones_like(j),))
    grad_px = jax.lax.stop_gradient(vm.safe_sqrt(gi * gi + gj * gj))
    sd = g / jnp.maximum(grad_px, 1e-20)
    sd_det = jax.lax.stop_gradient(sd)

    w_px = _kernel_width()
    near_edge = ((is_sph | is_tri) & (sd_det > 0.0) & (sd_det <= w_px)
                 & (grad_px > 1e-12))
    w = jnp.where(near_edge,
                  _edge_weight(sd_det, w_px, _kernel_order()), 0.0)

    # Background radiance: same rays/streams, winner excluded at bounce 0.
    excl = jnp.where(near_edge, prim0, -1).astype(jnp.int32)
    l_bg = trace(world, o_sg, d_sg, samp_keys, cfg.max_depth, cfg.t_min,
                 intersector=wb, nee=cfg.nee, rr_start=cfg.rr_start,
                 exclude_prim0=excl)

    delta = jax.lax.stop_gradient(l_full - l_bg)
    edge = (w * (sd - sd_det))[:, None] * delta

    # --- NEE shadow-edge boundary term (first vertex) -------------------
    # The pathwise estimator detaches the shadow ray's visibility V(x1, y),
    # so as x1 sweeps across a shadow boundary (camera/geometry motion)
    # the direct-light jump contributes no gradient. Measured on the mesh
    # Cornell at depth 1 (benchmarks/secondary_edge_bound.py): a 48%
    # pose-gradient deficit on the axis that drags x1 across the box
    # shadows. Same screen-space machinery as the silhouette term: the
    # shadow boundary on the receiver is a curve in IMAGE space — the
    # BLOCKER's interior margin along the shadow ray, as a function of
    # pixel coords through the DIFFERENTIABLY re-derived x1(i, j) and the
    # mirrored NEE light sample (same STREAM_BOUNCE0 slots 4-6 as
    # integrator._nee_mis, so the modeled jump is exactly the one l_full's
    # estimator experiences). delta_L = the occluded NEE contribution
    # (throughput = 1 at the first vertex), with fg = blocked (current):
    # (L_fg - L_bg) = -contrib. Deeper-vertex shadow/silhouette terms
    # remain unmodeled; their measured residual bound is in the ledger.
    do_shadow = cfg.nee and _os.environ.get("QTRT_EDGE_SHADOW", "1") != "0"
    if do_shadow:
        from ..core.integrator import INV_PI, _nee_direction
        from ..core.world import world_lights

        lights = world_lights(world)
    if do_shadow and lights.n_total > 0:
        u_b0 = sampling.stream_uniforms(samp_keys, sampling.STREAM_BOUNCE0,
                                        sampling.UNIFORMS_PER_BOUNCE)
        u4, u5, u6 = u_b0[:, 4], u_b0[:, 5], u_b0[:, 6]

        ldir0, pdf_j, valid_l, row_l, exp_prim, _ = _nee_direction(
            lights, p0_det, u4, u5, u6)
        cos_surf = vm.dot(n0_det, ldir0)
        cand = (jax.lax.stop_gradient(diffuse0)
                & jax.lax.stop_gradient(valid_l)
                & (jax.lax.stop_gradient(cos_surf) > 0.0))
        shadow = intersect_world(world, p0_det,
                                 jax.lax.stop_gradient(ldir0), cfg.t_min,
                                 backend=wb, alive=cand)
        lit = cand & shadow.hit & (shadow.prim_idx == exp_prim)
        blocked = cand & shadow.hit & ~lit

        pdf_nee = pdf_j / lights.n_total
        denom = pdf_nee + cos_surf * INV_PI
        den_f = jnp.where(cand, jnp.maximum(denom, 1e-30), 1.0)
        factor = jnp.where(cand, cos_surf * INV_PI / den_f, 0.0)
        contrib = jax.lax.stop_gradient(
            alb0_det * factor[:, None] * row_l[:, 9:12])

        # Blocker geometry (differentiable gathers: geometry recovery
        # sees its own shadow's motion).
        bidx = jax.lax.stop_gradient(shadow.prim_idx)
        if world.mesh is not None:
            nt = world.mesh.num_triangles
            btidx = jnp.clip(bidx - ns, 0, nt - 1)
            bv0 = world.mesh.v0[btidx]
            be1 = world.mesh.e1[btidx]
            be2 = world.mesh.e2[btidx]
        b_tri_det = jax.lax.stop_gradient(blocked & (bidx >= ns))
        if ns:
            bwidx = jnp.clip(bidx, 0, ns - 1)
            b_c = world.spheres.center[bwidx]
            b_r = world.spheres.radius[bwidx]
        hit0_det = jax.lax.stop_gradient(hit0)
        # Winner FAMILY for the re-derive: unlike is_tri_det (which carries
        # the front_face condition for the silhouette term's one-sidedness),
        # the hit-point re-derive must follow the geometric winner for
        # BACK-face hits too (a back-face wall still casts/receives
        # shadows; keying on is_tri_det silently re-derived those lanes
        # with the sphere formula — found via the isolated shadow-sweep FD
        # check, where it flipped the term's sign).
        is_tri_fam = jax.lax.stop_gradient(
            jnp.asarray(prim0 >= ns) & hit0_det)

        def x1_of(i_f, j_f):
            # Differentiable re-derive of the bounce-0 hit point from the
            # DETACHED winner ids (closed forms; no search).
            o, d = rays_of(i_f, j_f)
            if ns:
                oc = o - centers
                a = vm.length_squared(d)
                half_b = vm.dot(oc, d)
                c2t = vm.length_squared(oc) - radii * radii
                disc = jnp.maximum(half_b * half_b - a * c2t, 0.0)
                sq = vm.safe_sqrt(disc)
                inv_a = 1.0 / jnp.maximum(a, 1e-20)
                near_t = (-half_b - sq) * inv_a
                far_t = (-half_b + sq) * inv_a
                t_hit = jnp.where(near_t >= cfg.t_min, near_t, far_t)
            else:
                t_hit = jnp.ones_like(i_f)
            if world.mesh is not None:
                pv = jnp.cross(d, te2)
                dett = vm.dot(pv, te1)
                okd = jnp.abs(dett) > 1e-12
                inv_dt = jnp.where(okd, 1.0, 0.0) / jnp.where(okd, dett, 1.0)
                sv = o - tv0
                qv = jnp.cross(sv, te1)
                t_t = vm.dot(qv, te2) * inv_dt
                t_hit = jnp.where(is_tri_fam, t_t, t_hit)
            t_hit = jnp.where(hit0_det, jnp.maximum(t_hit, cfg.t_min), 1.0)
            return o + t_hit[:, None] * d

        def g_sh_of(i_f, j_f):
            x1 = x1_of(i_f, j_f)
            ld, _, _, _, _, _ = _nee_direction(lights, x1, u4, u5, u6)
            g = (_silhouette_g(x1, ld, b_c, b_r) if ns
                 else jnp.full(i_f.shape, -1.0))
            if world.mesh is not None:
                g = jnp.where(b_tri_det,
                              _tri_interior_g(x1, ld, bv0, be1, be2), g)
            return g

        g2 = g_sh_of(i, j)
        _, g2i = jax.jvp(lambda x: g_sh_of(x, j), (i,), (jnp.ones_like(i),))
        _, g2j = jax.jvp(lambda y: g_sh_of(i, y), (j,), (jnp.ones_like(j),))
        gp2 = jax.lax.stop_gradient(vm.safe_sqrt(g2i * g2i + g2j * g2j))
        sd2 = g2 / jnp.maximum(gp2, 1e-20)
        sd2_det = jax.lax.stop_gradient(sd2)
        near2 = (blocked & (sd2_det > 0.0) & (sd2_det <= w_px)
                 & (gp2 > 1e-12))
        w2 = jnp.where(near2,
                       _edge_weight(sd2_det, w_px, _kernel_order()), 0.0)
        edge = edge + (w2 * (sd2 - sd2_det))[:, None] * (-contrib)

    return l_full + edge
