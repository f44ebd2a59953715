"""PyTorch port vs JAX package: U²-Net and the SOD mask app.

- U2NetLite(mid=4, out=8) at 64x64 with the JAX package's initialized
  variables carried across by ``u2net_state_dict_from_flax``: all seven
  outputs within 2e-4;
- the U2NETP plan the other way: the port's seeded ``state_dict`` through
  the JAX ``convert_u2net_checkpoint`` (the original release's names), both
  outputs within 2e-4;
- ``generate_masks`` end to end on two 48x40 frames at 64x64 against the
  JAX app's masks from the same checkpoint, within one grey level, and the
  checkpoint formats (.pth, "/"-flattened .npz, Flax msgpack);
- ``resize_bicubic`` bit-equal to Pillow's BICUBIC on uint8.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import dynamicfuion_python_tpu.models.u2net as JU
import dynamicfuion_python_tpu_torch.models.u2net as PU
from dynamicfuion_python_tpu_torch.data.images import resize_bicubic
from dynamicfuion_python_tpu_torch.models.torch_weight_conversion import (
    load_u2net_checkpoint,
    u2net_flax_from_state_dict,
    u2net_state_dict_from_flax,
)
from dynamicfuion_python_tpu_torch.utils.telemetry import write_png

ATOL = 2e-4


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_outputs(model, variables, x_nchw: np.ndarray):
    out = jax.jit(model.apply)(variables, jnp.asarray(x_nchw.transpose(0, 2, 3, 1)))
    return [np.asarray(o)[..., 0] for o in out]


def _port_outputs(model, x_nchw: np.ndarray):
    with torch.no_grad():
        return [o[:, 0].numpy() for o in model.eval()(torch.as_tensor(x_nchw))]


def _randomized_variables(variables, seed: int):
    """JAX's init leaves BatchNorm at the identity; move its statistics and
    affine parameters so that eval-mode normalization is compared too."""
    rng = np.random.default_rng(seed)
    variables = _to_numpy(variables)

    def perturb(path, leaf):
        name = path[-1].key
        if name == "var":
            return (0.5 + rng.uniform(size=leaf.shape)).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        if name == "scale":
            return (0.8 + 0.4 * rng.uniform(size=leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, variables)


def test_u2net_lite_matches_jax_with_flax_variables():
    x = np.random.default_rng(0).normal(size=(1, 3, 64, 64)).astype(np.float32)
    jmodel = JU.U2NetLite(mid=4, out=8)
    variables = _randomized_variables(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), 1)
    pmodel = PU.U2NetLite(mid=4, out=8)
    pmodel.load_state_dict(u2net_state_dict_from_flax(variables), strict=True)
    want = _jax_outputs(jmodel, variables, x)
    got = _port_outputs(pmodel, x)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 64, 64)
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    # and back: the port's state_dict is the Flax variables it came from
    back = u2net_flax_from_state_dict(pmodel.state_dict())
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves_with_path(variables)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_u2netp_plan_state_dict_has_the_original_names():
    pmodel = PU.U2NetLite()
    state = PU.seeded_state_dict(pmodel, torch.Generator().manual_seed(3))
    pmodel.load_state_dict(state, strict=True)
    assert "stage1.rebnconvin.conv_s1.weight" in state and "stage6.rebnconv4.bn_s1.running_var" in state
    assert {"side1.weight", "side6.bias", "outconv.weight"} <= set(state)
    variables = JU.convert_u2net_checkpoint(state)  # the JAX package's reading of a release checkpoint
    jmodel = JU.U2NetLite()
    template = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    assert jax.tree.map(lambda a: a.shape, _to_numpy(template)) == jax.tree.map(lambda a: a.shape, variables)
    x = np.random.default_rng(1).normal(size=(1, 3, 64, 64)).astype(np.float32)
    got = _port_outputs(pmodel, x)
    want = _jax_outputs(jmodel, variables, x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def _write_frames(folder, count: int, size=(48, 40)):
    folder.mkdir(parents=True)
    rng = np.random.default_rng(7)
    h, w = size
    v, u = np.mgrid[0:h, 0:w]
    for i in range(count):
        blob = ((u - w / 2 - 3 * i) ** 2 + (v - h / 2) ** 2 < (min(h, w) / 3) ** 2)[..., None]
        img = np.where(blob, [200, 80, 40], [30, 90, 160]) + rng.integers(0, 40, size=(h, w, 3))
        write_png(folder / f"{i:06d}.png", np.clip(img, 0, 255).astype(np.uint8))


def test_generate_masks_matches_jax(tmp_path):
    from dynamicfuion_python_tpu.apps.sod import generate_masks as j_generate
    from dynamicfuion_python_tpu_torch.apps.sod import generate_masks as p_generate
    from dynamicfuion_python_tpu_torch.utils.telemetry import read_png

    frames = tmp_path / "color"
    _write_frames(frames, 2)
    model = PU.U2NetLite()
    ckpt = tmp_path / "u2netp.pth"
    torch.save(PU.seeded_state_dict(model, torch.Generator().manual_seed(5)), ckpt)
    want = j_generate(frames, tmp_path / "sod_jax", checkpoint=str(ckpt), resize_to=(64, 64))
    got = p_generate(frames, tmp_path / "sod_port", checkpoint=str(ckpt), resize_to=(64, 64), device="cpu")
    assert [p.name for p in got] == [p.name for p in want] == ["000000.png", "000001.png"]
    for g, w in zip(got, want):
        gm, wm = read_png(g), np.asarray(Image.open(w))
        assert gm.dtype == np.uint8 and gm.shape == wm.shape == (48, 40)
        assert np.abs(gm.astype(int) - wm.astype(int)).max() <= 1
        assert gm.max() > gm.min()  # a real mask, not a constant


def test_u2net_checkpoint_formats(tmp_path):
    import flax.serialization
    import flax.traverse_util

    model = PU.U2NetLite(mid=4, out=8)
    state = PU.seeded_state_dict(model, torch.Generator().manual_seed(9))
    variables = u2net_flax_from_state_dict(state)
    flat = flax.traverse_util.flatten_dict(variables, sep="/")
    np.savez(tmp_path / "u2net.npz", **flat)
    (tmp_path / "u2net.msgpack").write_bytes(flax.serialization.to_bytes(variables))
    torch.save(state, tmp_path / "u2net.pth")
    for name in ("u2net.pth", "u2net.npz", "u2net.msgpack"):
        loaded = PU.U2NetLite(mid=4, out=8)
        load_u2net_checkpoint(loaded, tmp_path / name)
        for key, value in loaded.state_dict().items():
            assert torch.equal(value, state[key]), (name, key)
    with pytest.raises(ValueError, match="configuration"):
        load_u2net_checkpoint(PU.U2NetLite(mid=4, out=16), tmp_path / "u2net.pth")


@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("size", [(320, 320), (20, 17), (48, 80)])
def test_resize_bicubic_equals_pillow(mode, size):
    rng = np.random.default_rng(11)
    shape = (48, 40, 3) if mode == "RGB" else (48, 40)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    want = np.asarray(Image.fromarray(img, mode).resize(size[::-1], Image.BICUBIC))
    np.testing.assert_array_equal(resize_bicubic(img, size), want)
    # Image.resize's default filter for these modes is BICUBIC
    np.testing.assert_array_equal(np.asarray(Image.fromarray(img, mode).resize(size[::-1])), want)
