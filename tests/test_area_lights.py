"""Area lights (emissive quads/triangles), MIS NEE, per-face materials.

BASELINE config 2 capability tests: the TRUE Cornell box (quad walls with
per-face albedos + an emissive ceiling quad) against the float64 oracle, the
variance win of area-sampled NEE+MIS over BSDF-only transport, and the
per-face material model (reference attaches materials per object,
include/raytracer/RayTracer.h:276-280 — here per face).
"""

import dataclasses

import jax
import numpy as np

from qt_raytracer import RenderConfig, render_linear, SceneBuilder
from qt_raytracer.accel.mesh import MeshBuilder, build_mesh
from qt_raytracer.core.world import World, world_lights
from qt_raytracer.models import meshes
from qt_raytracer.testing import oracle


def _cornell(emission=(15.0, 15.0, 15.0)):
    world = meshes.cornell_box_world(light_emission=emission,
                                     builder="python")
    cam = meshes.cornell_box_mesh_camera(1.0)
    return world, cam


def _compare_oracle(world, cam, cfg, seed, max_mismatch):
    key = jax.random.PRNGKey(seed)
    got = np.asarray(render_linear(world, cam, cfg, key), np.float64) / cfg.spp
    want = oracle.render_oracle_linear(world, cam, cfg, key) / cfg.spp
    mismatch = np.abs(got - want) > (4e-3 + 4e-3 * np.abs(want))
    assert mismatch.mean() <= max_mismatch, (
        f"mismatch fraction {mismatch.mean():.4f} > {max_mismatch}")


def test_cornell_mesh_matches_oracle():
    # BSDF-only transport through the true box (quad light hit directly).
    cfg = RenderConfig(width=12, height=12, spp=2, max_depth=5)
    world, cam = _cornell()
    _compare_oracle(world, cam, cfg, seed=0, max_mismatch=0.02)


def test_cornell_mesh_nee_mis_matches_oracle():
    # The full MIS machinery: uniform-area triangle-light sampling, shadow
    # rays against the merged sphere+mesh id space, and balance-heuristic
    # weighting of BSDF-sampled emitter hits — all mirrored scalar-exactly.
    cfg = RenderConfig(width=12, height=12, spp=2, max_depth=5, nee=True)
    world, cam = _cornell()
    _compare_oracle(world, cam, cfg, seed=1, max_mismatch=0.02)


def test_area_light_nee_unbiased_and_lower_variance():
    # Same scene, NEE+MIS on vs off: means agree (unbiased), and at 8x fewer
    # spp the MIS estimator still beats BSDF-only MSE — the whole point of
    # area-sampled next-event estimation in an enclosed box. Camera aimed so
    # the light quad is OUT of frame: direct-visible-light pixels are pure
    # antialiasing-jitter noise that no light-sampling strategy reduces, and
    # at 8x8 they would swamp the MSE comparison (same setup as the sphere
    # NEE test in test_oracle_golden.py).
    from qt_raytracer.core.camera import make_camera
    world, _ = _cornell()
    cam = make_camera((0.0, 0.7, 3.4), (0.0, 0.5, 0.0), vup=(0, 1, 0),
                      vfov=22.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.4)
    key = jax.random.PRNGKey(3)
    base = dict(width=8, height=8, max_depth=6, samples_per_batch=8)
    img_off = np.asarray(render_linear(
        world, cam, RenderConfig(spp=256, **base), key)) / 256
    img_on = np.asarray(render_linear(
        world, cam, RenderConfig(spp=32, nee=True, **base), key)) / 32
    assert np.abs(img_on.mean() - img_off.mean()) / img_off.mean() < 0.15
    ref = np.asarray(render_linear(
        world, cam, RenderConfig(spp=512, nee=True, **base),
        jax.random.PRNGKey(7))) / 512
    err_off = np.mean((img_off - ref) ** 2)
    err_on = np.mean((img_on - ref) ** 2)
    assert err_on < err_off, (err_on, err_off)


def test_mis_weights_partition():
    # Balance heuristic invariant: for a direction NEE could have produced,
    # light-sample factor + emitter-hit weight == the plain 1/pdf estimator
    # split in two. Checked indirectly: a scene where the light is sampled
    # ONLY via NEE (light behind an occluder for BSDF rays) and only via
    # BSDF (NEE shadow rays blocked) must each stay unbiased — covered by
    # the oracle agreement above; here check the weights are in [0,1].
    from qt_raytracer.core.integrator import _sphere_solid_angle_pdf
    import jax.numpy as jnp
    c = jnp.array([[0.0, 5.0, 0.0]])
    r = jnp.array([1.0])
    p = jnp.array([[0.0, 0.0, 0.0]])
    pdf, ok, cos_max, _, _ = _sphere_solid_angle_pdf(c, r, p)
    assert bool(ok[0]) and float(pdf[0]) > 0.0
    # pdf of a cone covering sin2 = 1/25: 1/(2pi(1-cos_max))
    want = 1.0 / (2.0 * np.pi * (1.0 - np.sqrt(1.0 - 1.0 / 25.0)))
    np.testing.assert_allclose(float(pdf[0]), want, rtol=1e-5)


def test_per_face_materials_roundtrip():
    # build_mesh accepts per-face arrays; BVH reorder keeps the
    # face->material binding (albedo follows its triangle).
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                      [3, 0, 0], [4, 0, 0], [3, 1, 0]], np.float64)
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    alb = np.array([[0.9, 0.1, 0.1], [0.1, 0.9, 0.1]])
    mt = np.array([0, 3], np.int32)
    em = np.array([[0, 0, 0], [5, 5, 5]], np.float64)
    mesh = build_mesh(verts, faces, mat_type=mt, albedo=alb, emission=em,
                      builder="python")
    # Whatever the BVH order, the face whose v0.x >= 3 is the emissive one.
    v0 = np.asarray(mesh.v0)
    right = int(np.argmax(v0[:, 0]))
    assert int(np.asarray(mesh.mat_type)[right]) == 3
    np.testing.assert_allclose(np.asarray(mesh.albedo)[right],
                               [0.1, 0.9, 0.1], atol=1e-6)
    np.testing.assert_array_equal(np.asarray(mesh.light_tri), [right])


def test_mesh_builder_quad_and_box():
    m = MeshBuilder()
    m.add_quad((0, 0, 0), (1, 0, 0), (0, 1, 0), albedo=(1, 0, 0))
    m.add_box((0, 0, 0), (2, 2, 2), albedo=(0, 1, 0))
    mesh = m.build(builder="python")
    assert mesh.num_triangles == 2 + 12
    # Quad area: two triangles of a unit square sum to 1.
    cr = np.cross(np.asarray(mesh.e1), np.asarray(mesh.e2))
    areas = 0.5 * np.linalg.norm(cr, axis=1)
    np.testing.assert_allclose(areas.sum(), 1.0 + 6 * 4.0, rtol=1e-6)
    assert mesh.num_lights == 0


def test_world_light_table_merges_families():
    # Sphere light + two emissive faces -> 3 rows, spheres first, unified
    # prim ids offset by num_spheres for faces.
    b = SceneBuilder()
    b.lambertian((0, -1000, 0), 1000.0, (0.5, 0.5, 0.5))
    b.emissive((0, 5, 0), 1.0, (10, 10, 10))
    sc = b.build(pad_to=None)
    m = MeshBuilder()
    m.add_quad((-1, 3, -1), (2, 0, 0), (0, 0, 2), mat_type=3,
               emission=(4, 4, 4))
    world = World(spheres=sc, mesh=m.build(builder="python"))
    lights = world_lights(world)
    assert lights.n_sphere == 1 and lights.n_total == 3
    ep = np.asarray(lights.expected_prim)
    assert ep[0] == 1  # the emissive sphere's index
    assert (ep[1:] >= sc.num_spheres).all()
    # Sphere row: center/radius/emission slots.
    row = np.asarray(lights.table)[0]
    np.testing.assert_allclose(row[0:4], [0, 5, 0, 1.0], atol=1e-6)
    np.testing.assert_allclose(row[9:12], [10, 10, 10], atol=1e-6)


def test_nee_compiled_out_without_lights():
    # nee=True on a light-less world must render fine (NEE statically
    # compiled out: world_lights -> n_total == 0).
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=3, nee=True)
    scene = SceneBuilder().lambertian((0, 0, -3), 1.0, (0.5, 0.5, 0.5)).build(
        pad_to=None)
    from qt_raytracer.core.camera import make_camera
    cam = make_camera((0, 0, 0), (0, 0, -3), vfov=40, aspect_ratio=1.0)
    img = np.asarray(render_linear(scene, cam, cfg, jax.random.PRNGKey(0)))
    assert np.isfinite(img).all()


def test_cornell_mesh_gradients_flow():
    # Per-face albedo and the light quad's emission are gradient targets
    # through the full NEE+MIS path.
    import jax.numpy as jnp
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=3, nee=True)
    world, cam = _cornell()
    key = jax.random.PRNGKey(0)

    def loss(albedo, emission):
        w2 = World(spheres=world.spheres,
                   mesh=dataclasses.replace(world.mesh, albedo=albedo,
                                            emission=emission))
        return jnp.mean(render_linear(w2, cam, cfg, key))

    ga, ge = jax.grad(loss, argnums=(0, 1))(world.mesh.albedo,
                                            world.mesh.emission)
    ga, ge = np.asarray(ga), np.asarray(ge)
    assert np.isfinite(ga).all() and np.abs(ga).max() > 0
    assert np.isfinite(ge).all() and np.abs(ge).max() > 0
