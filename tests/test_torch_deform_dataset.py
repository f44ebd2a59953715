"""The port's training data against the JAX package on the CPU: PNG decoding
without Pillow (Pillow-written files, every row filter), Pillow's NEAREST
and BILINEAR resizes, ``DeformDataset`` and ``LabeledDeformDataset`` batches
on ``tmp_path`` splits, and ``StaticCenterCrop``. Integer arrays must be
equal, float arrays within 1e-6; decoded PNGs and nearest resizes equal;
bilinear resizes within 1 grey level."""

import json
import zlib

import numpy as np
import pytest
from PIL import Image

from dynamicfuion_python_tpu_torch.data.images import load_color, load_depth, resize_bilinear, resize_nearest
from dynamicfuion_python_tpu_torch.utils.telemetry import read_png


def _same(got, want, atol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind, (got.shape, want.shape, got.dtype, want.dtype)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _row_filters(path) -> set:
    """The filter byte of every row of a (non-interlaced) PNG."""
    data = open(path, "rb").read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        length = int.from_bytes(data[pos : pos + 4], "big")
        tag, payload = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            header = payload
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    w, h = int.from_bytes(header[:4], "big"), int.from_bytes(header[4:8], "big")
    bpp = {(8, 0): 1, (16, 0): 2, (8, 2): 3, (8, 4): 2, (8, 6): 4}[(header[8], header[9])]
    raw = zlib.decompress(idat)
    return {raw[r * (1 + w * bpp)] for r in range(h)}


def _images(rng, h=61, w=83):
    v, u = np.mgrid[0:h, 0:w]
    noise = rng.integers(0, 256, (h, w, 3))
    rgb = np.where((v < h // 3)[..., None], noise, np.stack([u * 3, v * 4, u * v], -1) % 256).astype(np.uint8)
    depth = (900 + 5 * u + 3 * v + rng.integers(0, 40, (h, w))).astype(np.uint16)
    depth[h // 2 :, w // 2 :] = rng.integers(0, 65535, (h - h // 2, w - w // 2))
    return {
        "rgb": rgb, "grey": rgb[..., 1].copy(), "depth16": depth,
        "rgba": np.concatenate([rgb, rgb[..., :1]], -1), "grey_alpha": np.stack([rgb[..., 0], rgb[..., 2]], -1),
    }


def _filtered_png(path, img: np.ndarray, color_type: int):
    """Write ``img`` as a PNG whose row r uses filter r % 5 (none, sub, up,
    average, Paeth): Pillow's own encoder never picks the average filter."""
    h = img.shape[0]
    big = img.dtype == np.uint16
    raw = np.ascontiguousarray(img.astype(">u2") if big else img).view(np.uint8).reshape(h, -1).astype(np.int64)
    bpp = (2 if big else 1) * (1 if img.ndim == 2 else img.shape[2])
    rows = []
    for r in range(h):
        x = raw[r]
        up = raw[r - 1] if r else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][r % 5]
        rows.append(bytes([r % 5]) + ((x - pred) % 256).astype(np.uint8).tobytes())
    w = img.shape[1]

    def chunk(tag, payload):
        return len(payload).to_bytes(4, "big") + tag + payload + zlib.crc32(tag + payload).to_bytes(4, "big")

    header = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([16 if big else 8, color_type, 0, 0, 0])
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


def test_png_decoding_matches_pillow_for_every_row_filter(tmp_path, rng):
    """Files Pillow writes (its adaptive filtering picks none, sub, up and
    Paeth), and files with every filter in turn, decoded as Pillow decodes
    them."""
    filters = set()
    color_types = {"rgb": 2, "grey": 0, "depth16": 0, "rgba": 6, "grey_alpha": 4}
    for name, img in _images(rng).items():
        path = tmp_path / f"{name}.png"
        Image.fromarray(img, mode="LA" if name == "grey_alpha" else None).save(path)
        filters |= _row_filters(path)
        _same(read_png(path), np.asarray(Image.open(path)))
        forced = tmp_path / f"{name}_forced.png"
        _filtered_png(forced, img, color_types[name])
        assert _row_filters(forced) == {0, 1, 2, 3, 4}
        _same(read_png(forced), np.asarray(Image.open(forced)))
        _same(read_png(forced), img)
    assert {0, 1, 2, 4} <= filters, filters
    # the colour and depth loaders: Pillow's convert("RGB") and uint16
    _same(load_color(tmp_path / "rgba.png"), np.asarray(Image.open(tmp_path / "rgba.png").convert("RGB")))
    _same(load_color(tmp_path / "grey.png"), np.asarray(Image.open(tmp_path / "grey.png").convert("RGB")))
    _same(load_depth(tmp_path / "depth16.png"), np.asarray(Image.open(tmp_path / "depth16.png"), np.uint16))


def test_jpeg_needs_pillow_and_says_so(tmp_path, rng, monkeypatch):
    rgb = _images(rng)["rgb"]
    Image.fromarray(rgb).save(tmp_path / "c.jpg")
    _same(load_color(tmp_path / "c.jpg"), np.asarray(Image.open(tmp_path / "c.jpg").convert("RGB")))
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(RuntimeError, match="needs Pillow"):
        load_color(tmp_path / "c.jpg")
    from dynamicfuion_python_tpu_torch.utils.telemetry import write_png

    write_png(tmp_path / "c.png", rgb)  # a PNG still reads
    _same(load_color(tmp_path / "c.png"), rgb)


SIZES = [(61, 83, 32, 48), (61, 83, 128, 192), (480, 640, 448, 640), (480, 640, 240, 320), (100, 100, 99, 101),
         (37, 53, 7, 9), (64, 64, 64, 64)]


@pytest.mark.parametrize("size", SIZES, ids=[f"{a}x{b}-{c}x{d}" for a, b, c, d in SIZES])
def test_resizes_match_pillow(size, rng):
    h0, w0, h, w = size
    if (h0, w0) == (480, 640):
        imgs = {"rgb": rng.integers(0, 256, (h0, w0, 3)).astype(np.uint8)}
        imgs["depth16"] = rng.integers(0, 65535, (h0, w0)).astype(np.uint16)
    else:
        imgs = _images(rng, h0, w0)
    for name, img in imgs.items():
        if name in ("rgba", "grey_alpha"):
            continue
        want = np.asarray(Image.fromarray(img).resize((w, h), Image.NEAREST))
        _same(resize_nearest(img, (h, w)), want)
        if img.dtype == np.uint8:
            want = np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR)).astype(int)
            got = resize_bilinear(img, (h, w)).astype(int)
            assert got.shape == want.shape and np.abs(got - want).max() <= 1
    flow = rng.normal(size=(h0, w0)).astype(np.float32)
    _same(resize_nearest(flow, (h, w)), np.asarray(Image.fromarray(flow).resize((w, h), Image.NEAREST)), atol=0)


def _compare_batches(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        _same(got[key], want[key])


@pytest.mark.parametrize("image_size", [None, (64, 128), (48, 64)])
def test_deform_dataset_matches_jax(tmp_path, image_size):
    """Graphs built on the fly from the source depth; the PNG split of
    ``data/synthetic_pairs.py`` at 72x96, read at its own size and resized
    up and down (depth and flows nearest, colour bilinear)."""
    from dynamicfuion_python_tpu.data.deform_dataset import DeformDataset as JaxDataset
    from dynamicfuion_python_tpu_torch.data.deform_dataset import DeformDataset
    from dynamicfuion_python_tpu_torch.data.synthetic_pairs import write_split

    write_split(tmp_path / "train", (72, 96))
    kwargs = dict(max_nodes=64, node_coverage=0.1, image_size=image_size)
    got_ds, want_ds = DeformDataset(tmp_path / "train", **kwargs), JaxDataset(tmp_path / "train", **kwargs)
    assert [p[:3] for p in got_ds.pairs] == [p[:3] for p in want_ds.pairs] and len(got_ds) == 4
    _compare_batches(got_ds.batch([0, 3]), want_ds.batch([0, 3]))
    _compare_batches(got_ds.batch([2]), want_ds.batch([2]))


def _labeled_split(tmp_path, rng, h=64, w=96, n=6):
    """TestLabeledDeformDataset._build of tests/test_training_stack.py with
    PNG colour frames."""
    from dynamicfuion_python_tpu.data import io as blob_io

    base = tmp_path / "ds"
    sd = base / "seq"
    sd.mkdir(parents=True)
    depth = np.full((h, w), 1000, np.uint16)
    depth[: h // 2] = 1500
    color = rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)
    for name in ("src", "tgt"):
        Image.fromarray(color).save(sd / f"{name}c.png")
        Image.fromarray(depth).save(sd / f"{name}.png")
    flow = rng.normal(size=(2, h, w)).astype(np.float32)
    flow[:, 0, 0] = np.nan
    blob_io.save_flow_binary(sd / "p.oflow", flow)
    blob_io.save_flow_binary(sd / "p.sflow", rng.normal(size=(3, h, w)).astype(np.float32))
    blob_io.save_graph_nodes(sd / "p_nodes.bin", rng.normal(size=(n, 3)).astype(np.float32))
    blob_io.save_graph_edges(sd / "p_edges.bin", rng.integers(-1, n, size=(n, 10)).astype(np.int32))
    blob_io.save_graph_edges_weights(sd / "p_ew.bin", rng.random(size=(n, 10)).astype(np.float32))
    blob_io.save_graph_clusters(sd / "p_clusters.bin", np.zeros((n, 1), np.int32))
    blob_io.save_graph_node_deformations(sd / "p_deforms.bin", rng.normal(size=(n, 3)).astype(np.float32))
    blob_io.save_int_image(sd / "p_anchors.bin", rng.integers(-1, n, size=(h, w, 4)).astype(np.int32))
    blob_io.save_float_image(sd / "p_weights.bin", rng.random(size=(h, w, 4)).astype(np.float32))
    entry = {
        "source_color": "seq/srcc.png", "source_depth": "seq/src.png", "target_color": "seq/tgtc.png",
        "target_depth": "seq/tgt.png", "optical_flow": "seq/p.oflow", "scene_flow": "seq/p.sflow",
        "graph_nodes": "seq/p_nodes.bin", "graph_edges": "seq/p_edges.bin", "graph_edges_weights": "seq/p_ew.bin",
        "graph_clusters": "seq/p_clusters.bin", "graph_node_deformations": "seq/p_deforms.bin",
        "pixel_anchors": "seq/p_anchors.bin", "pixel_weights": "seq/p_weights.bin",
        "intrinsics": {"fx": 100.0, "fy": 100.0, "cx": w / 2, "cy": h / 2},
    }
    (base / "train.json").write_text(json.dumps([entry, dict(entry, graph_node_deformations="")]))
    return base


def test_labeled_dataset_matches_jax(tmp_path, rng):
    """Precomputed blobs (random, 10 neighbors cut to 8), a depth step for
    the boundary mask, a NaN flow pixel, center crop 32x64."""
    from dynamicfuion_python_tpu.data.deform_dataset import LabeledDeformDataset as JaxLabeled
    from dynamicfuion_python_tpu_torch.data.deform_dataset import LabeledDeformDataset

    base = _labeled_split(tmp_path, rng)
    kwargs = dict(input_size=(32, 64), max_nodes=8, max_neighbors=8)
    got_ds, want_ds = LabeledDeformDataset(base, "train", **kwargs), JaxLabeled(base, "train", **kwargs)
    _compare_batches(got_ds.batch([0]), want_ds.batch([0]))
    _compare_batches(got_ds.batch([0, 1]), want_ds.batch([0, 1]))
    assert got_ds.batch([0])["target_boundary_mask"].any()


def test_labeled_split_from_the_generator_matches_jax(tmp_path):
    """The labels and graphs ``create_graph_data`` writes for a synthetic
    split, read by both packages' ``LabeledDeformDataset`` (crop 64x128 of
    72x128)."""
    from dynamicfuion_python_tpu.data.deform_dataset import LabeledDeformDataset as JaxLabeled
    from dynamicfuion_python_tpu_torch.apps import create_graph_data
    from dynamicfuion_python_tpu_torch.data.deform_dataset import LabeledDeformDataset, StaticCenterCrop
    from dynamicfuion_python_tpu_torch.data.synthetic_pairs import write_split
    from dynamicfuion_python_tpu.data.deform_dataset import StaticCenterCrop as JaxCrop

    for seq in write_split(tmp_path / "train", (72, 128)):
        create_graph_data.main([str(seq), "--node-coverage", "0.08", "--frames", "0", "--labels", str(tmp_path / "train.json")])
    got_ds = LabeledDeformDataset(tmp_path, "train", input_size=(64, 128), max_nodes=64)
    want_ds = JaxLabeled(tmp_path, "train", input_size=(64, 128), max_nodes=64)
    assert len(got_ds) == 4 and got_ds.pair_name(3) == "bend_000000_000002"
    _compare_batches(got_ds.batch([0, 1, 2, 3]), want_ds.batch([0, 1, 2, 3]))
    k = np.asarray([[100.0, 0, 40], [0, 90.0, 30], [0, 0, 1]], np.float32)
    _same(StaticCenterCrop((72, 128), (64, 96)).adjust_intrinsics(k), JaxCrop((72, 128), (64, 96)).adjust_intrinsics(k))
    with pytest.raises(ValueError, match="larger"):
        StaticCenterCrop((72, 128), (128, 128))
