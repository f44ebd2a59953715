"""The port's renderer and everything around it against the JAX package, on
the CPU: interpolation and the three shaders (1e-6), MeshRenderer on the
64x64 quad of tests/test_rendering_and_extras.py and on a 64x96
bending-plane mesh (depth and color 1e-5, the hit mask equal), the PNG
encoder against the JAX recorder's files (decoded by Pillow), and the
visualizer's render_run (within 1/255) and render_gn_playback on a tiny
recorded run, file by file."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dynamicfuion_python_tpu.apps import visualizer as JVis
from dynamicfuion_python_tpu.data.frame_sequence import SyntheticBendingPlaneSequence
from dynamicfuion_python_tpu.models.renderer import MeshRenderer as JRenderer
from dynamicfuion_python_tpu.ops import interpolate as JI, rasterize as JR, shading as JS
from dynamicfuion_python_tpu.settings import TelemetryConfig as JTelemetryConfig
from dynamicfuion_python_tpu.utils import telemetry as JT
from dynamicfuion_python_tpu_torch.apps import visualizer as PVis
from dynamicfuion_python_tpu_torch.models.renderer import MeshRenderer as PRenderer
from dynamicfuion_python_tpu_torch.models.voxel_block_grid import VoxelBlockGrid as PV
from dynamicfuion_python_tpu_torch.models.voxel_block_grid import extract_mesh_fitter_arrays as p_extract_mesh
from dynamicfuion_python_tpu_torch.ops import interpolate as PI, rasterize as PR, shading as PS
from dynamicfuion_python_tpu_torch.settings import TelemetryConfig as PTelemetryConfig
from dynamicfuion_python_tpu_torch.utils import telemetry as PT

QUAD_INTR = np.asarray([[100.0, 0.0, 32.0], [0.0, 100.0, 32.0], [0.0, 0.0, 1.0]], np.float32)


def _quad(z=1.0, half=0.2):
    verts = np.asarray([[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]], np.float32)
    return verts, np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)


def _jax_fragments(rng, k=2):
    """A random soup's K = 2 fragments from the JAX naive rasterizer, as
    numpy (both packages' shaders read the same buffers)."""
    verts = rng.uniform(-0.4, 0.4, size=(120, 3)).astype(np.float32)
    verts[:, 2] = rng.uniform(0.8, 2.0, size=120)
    tris = np.arange(120, dtype=np.int32).reshape(-1, 3)
    fv, valid = JR.extract_face_vertices(jnp.asarray(verts), jnp.asarray(tris), jnp.asarray(QUAD_INTR), (64, 64))
    frag = JR.rasterize_naive(fv, valid, (64, 64), faces_per_pixel=k)
    return verts, tris, [np.asarray(x) for x in frag]


def _pair(arrays):
    return JR.Fragments(*[jnp.asarray(a) for a in arrays]), PR.Fragments(*[torch.as_tensor(a) for a in arrays])


def test_interpolation_and_shaders_match_jax(rng):
    verts, tris, arrays = _jax_fragments(rng)
    jf, pf = _pair(arrays)
    assert (arrays[0][..., 0] >= 0).sum() > 300
    attrs = rng.normal(size=(len(verts), 5)).astype(np.float32)
    face_attrs = JI.vertex_attributes_to_face(jnp.asarray(attrs), jnp.asarray(tris))
    p_face_attrs = PI.vertex_attributes_to_face(torch.as_tensor(attrs), torch.as_tensor(tris))
    np.testing.assert_array_equal(p_face_attrs.numpy(), np.asarray(face_attrs))
    want = JI.interpolate_face_attributes(jf.face_indices, jf.barycentrics, face_attrs)
    got = PI.interpolate_face_attributes(pf.face_indices, pf.barycentrics, p_face_attrs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    colors = rng.uniform(size=(len(verts), 3)).astype(np.float32)
    normals = rng.normal(size=(len(verts), 3)).astype(np.float32)
    cases = [
        (JS.vertex_color_shader(jf, jnp.asarray(colors), jnp.asarray(tris)),
         PS.vertex_color_shader(pf, torch.as_tensor(colors), torch.as_tensor(tris))),
        (JS.flat_edge_shader(jf), PS.flat_edge_shader(pf)),
        (JS.normal_shader(jf, jnp.asarray(normals), jnp.asarray(tris)),
         PS.normal_shader(pf, torch.as_tensor(normals), torch.as_tensor(tris))),
        (JS.flat_edge_shader(jf, face_color=(0.1, 0.2, 0.3), edge_width_barycentric=0.2, background=(0, 0, 1)),
         PS.flat_edge_shader(pf, face_color=(0.1, 0.2, 0.3), edge_width_barycentric=0.2, background=(0, 0, 1))),
    ]
    for want, got in cases:
        assert got.shape == (64, 64, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _bending_plane_mesh():
    """The 64x96 bending plane's frame-0 surface: integrated into a volume
    and extracted as the fitter's padded mesh arrays (by the port; both
    renderers then take the same arrays)."""
    seq = SyntheticBendingPlaneSequence(frame_count=1, image_size=(64, 96), bend_per_frame=0.02, focal=120.0)
    frame = seq.load_frame(0)
    k = torch.as_tensor(seq.intrinsics)
    depth = torch.as_tensor(frame.depth.astype(np.int32))
    grid = PV.create(capacity=512, voxel_size=0.01, block_resolution=8, sdf_truncation_distance=0.04,
                     depth_scale=1000.0, depth_max=2.0, device="cpu")
    grid = grid.activate(grid.compute_unique_block_coordinates(depth, k, stride=2))
    verts, faces, _, n = p_extract_mesh(grid.integrate(depth, k), 8192, 16384, 0.0)
    assert int(n) > 1000
    return verts.numpy(), faces.numpy(), seq.intrinsics, (64, 96)


@pytest.mark.parametrize("scene", ["quad", "bending_plane"])
def test_mesh_renderer_matches_jax(scene, rng):
    if scene == "quad":
        verts, tris = _quad()
        intr, size = QUAD_INTR, (64, 64)
    else:
        verts, tris, intr, size = _bending_plane_mesh()
    colors = rng.uniform(size=(len(verts), 3)).astype(np.float32)
    jr = JRenderer(size, jnp.asarray(intr))
    pr = PRenderer(size, intr, device="cpu")
    for vertex_colors in (None, colors):
        jc, jd = jr.render_mesh(jnp.asarray(verts), jnp.asarray(tris),
                                None if vertex_colors is None else jnp.asarray(vertex_colors))
        pc, pd = pr.render_mesh(torch.as_tensor(verts), torch.as_tensor(tris),
                                None if vertex_colors is None else torch.as_tensor(vertex_colors))
        jd, jc = np.asarray(jd), np.asarray(jc)
        hit = jd > 0
        np.testing.assert_array_equal(pd.numpy() > 0, hit)
        assert hit.sum() > 500
        np.testing.assert_allclose(pd.numpy(), jd, atol=1e-5)
        np.testing.assert_allclose(pc.numpy(), jc, atol=1e-5)
    if scene == "quad":  # the JAX test's gates, on the port
        assert np.allclose(pd.numpy()[25:40, 25:40], 1.0, atol=1e-4) and (pd.numpy()[:10] == 0).all()


def test_png_encoder_matches_the_jax_recorder(tmp_path, rng):
    color = rng.uniform(-0.1, 1.1, size=(30, 40, 3)).astype(np.float32)
    depth = rng.uniform(0.0, 70.0, size=(30, 40)).astype(np.float32)  # past 65.535 m clips
    for pkg, cfg_cls, tel, arrays in (
        ("jax", JTelemetryConfig, JT, (jnp.asarray(color), jnp.asarray(depth))),
        ("port", PTelemetryConfig, PT, (torch.as_tensor(color), torch.as_tensor(depth))),
    ):
        cfg = dataclasses.replace(cfg_cls(), output_directory=str(tmp_path / pkg), record_rendered_warped_mesh=True)
        tel.TelemetryRecorder(cfg, run_name="run").record_rendered_warped_mesh(3, *arrays)
    for name in ("000003_rendered_color.png", "000003_rendered_depth.png"):
        want = Image.open(tmp_path / "jax" / "run" / name)
        got = Image.open(tmp_path / "port" / "run" / name)
        assert got.mode == want.mode and got.size == want.size == (40, 30)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        # the port's own reader (chip_smoke.py reads the files with it)
        np.testing.assert_array_equal(PT.read_png(tmp_path / "port" / "run" / name), np.asarray(want))
    assert np.asarray(Image.open(tmp_path / "port" / "run" / "000003_rendered_depth.png")).max() == 65535
    with pytest.raises(ValueError):
        PT.write_png(tmp_path / "bad.png", np.zeros((4, 4), np.float32))


def _recorded_run(run_dir, rng):
    """Two frames of canonical / warped bending-plane soups and GN records,
    written by the JAX recorder."""
    verts, faces, _, _ = _bending_plane_mesh()
    soup = verts[faces[:3000]]
    rec = JT.TelemetryRecorder(dataclasses.replace(JTelemetryConfig(), output_directory=str(run_dir),
                                                   record_gn_point_clouds=True), run_name="run")
    for f in (1, 2):
        rec.record_meshes(f, canonical=soup, warped=soup + [0.01 * f, 0.0, 0.02 * f])
        rec.record_gn_iterations(
            f, rng.uniform(size=3), rng.uniform(size=3),
            rng.normal(scale=0.01, size=(3, 12, 3)).astype(np.float32),
            rng.uniform(-0.2, 0.2, size=(12, 3)).astype(np.float32) + [0, 0, 1.0],
        )
    return run_dir / "run"


def test_visualizer_matches_jax(tmp_path, rng):
    run = _recorded_run(tmp_path, rng)
    size = (48, 64)
    jnames = JVis.render_run(run, tmp_path / "jax", image_size=size)
    pnames = PVis.render_run(run, tmp_path / "port", image_size=size, device="cpu")
    assert pnames == jnames and len(pnames) == 4
    for name in pnames:
        want = np.asarray(Image.open(tmp_path / "jax" / name)).astype(int)
        got = np.asarray(Image.open(tmp_path / "port" / name)).astype(int)
        assert (want < 250).sum() > 300  # the mesh is in view
        assert np.abs(got - want).max() <= 1
    assert (tmp_path / "port" / "index.html").read_text() == (tmp_path / "jax" / "index.html").read_text()

    jframes = JVis.render_gn_playback(run, tmp_path / "jax_gn", image_size=(60, 80))
    pframes = PVis.main(["--run", str(run), "--out", str(tmp_path / "port_gn"), "--size", "60x80", "--gn-playback"])
    assert pframes == jframes and sum(len(v) for v in pframes.values()) == 6
    for names in pframes.values():
        for name in names:
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port_gn" / name)),
                                          np.asarray(Image.open(tmp_path / "jax_gn" / name)))
    assert (tmp_path / "port_gn" / "gn_playback.html").read_text() == (
        tmp_path / "jax_gn" / "gn_playback.html").read_text()
