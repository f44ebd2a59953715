"""Salient-object-detection masks for RGB sequences (port of
``dynamicfuion_python_tpu/apps/sod.py``).

Walks a DeepDeform split / sequence (or a given input folder), runs U²-Net
(``models/u2net.py``) on each colour frame and writes a greyscale saliency
mask (0-255 PNG, the frame's stem) into the ``sod`` folder the fusion data
layer reads for background subtraction.

:func:`masks_for_frames` runs frames in batches. Per batch: the colour
frames are read on the host and uploaded once as uint8; on the device they
are resized to 320x320 by Pillow's bicubic filter
(``data/images.py::resize_images``, bit-equal to ``resize_bicubic``),
scaled by each image's maximum and normalized with the ImageNet mean and
deviation, in the JAX package's order and types; U²-Net's forward runs with
TF32 off for cuBLAS and cuDNN; the fused output is min-max normalized,
quantized to uint8 and resized back to the frame's size bicubically, still
on the device; the host reads the uint8 masks once and writes them with
``utils/telemetry.py::write_png``. The host writes the batch before's
masks and reads the next batch's frames while the device runs a batch,
each batch's PNGs decoded or encoded at once on a pool of threads, one per
CPU (zlib works outside the interpreter's lock): on the loop's own thread
the codec took four times the forward's time on an H100. Masks are written
at zlib level 1. PNG frames need no Pillow; a JPEG frame does.

Spans (``utils/trace.py``, off by default): ``sod`` per batch (its item the
batch number) > ``sod.preprocess``, ``sod.forward``, ``sod.postprocess``,
``sod.write`` (the batch before's masks, read back first as
``host_read.sod.masks``), ``sod.read`` (the next batch's frames; the first
batch's reads come before any ``sod`` span, the last batch's masks in a
``sod`` span of their own); the codec's spans are its wall time.
Counters: ``sod.batches``, ``sod.frames`` (masks written),
``host_write.sod.frames`` (one upload a batch), ``host_read.sod.masks``
(one read a batch).

``--checkpoint`` is an original-release ``u2net.pth`` / ``u2netp.pth``
(``--full`` for the big model), an ``.npz`` of Flax variables flattened with
"/" or a Flax msgpack file. Without one the weights are seeded (only useful
to exercise the pipeline) and a warning is printed.

Run: python -m dynamicfuion_python_tpu_torch.apps.sod (-i <folder> |
        -d <root> -sp train -si 70) [-o sod] [-c <checkpoint>] [--full]
        [--threshold t] [--batch_size 16] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import functools
import itertools
import os
import sys
from collections.abc import Iterable, Iterator
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.apps.train import fp32_step
from dynamicfuion_python_tpu_torch.data.images import load_color, resize_images
from dynamicfuion_python_tpu_torch.models.torch_weight_conversion import load_u2net_checkpoint
from dynamicfuion_python_tpu_torch.models.u2net import U2Net, U2NetFull, U2NetLite, seeded_state_dict
from dynamicfuion_python_tpu_torch.utils import trace
from dynamicfuion_python_tpu_torch.utils.device import resolve_device
from dynamicfuion_python_tpu_torch.utils.telemetry import write_png

PROGRAM_EXIT_SUCCESS = 0
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SEED = 0
# zlib's fastest level for the masks: at the default 6 a 480x640 mask of
# seeded weights took ~14 ms of CPU on an H100 machine's host, at 1 ~4 ms,
# for files ~14% larger and the same pixels; at 6 the codec, not the
# network, paced the loop
MASK_COMPRESS_LEVEL = 1


def build_model(checkpoint: str | None = None, full_model: bool = False, device=None) -> U2Net:
    """U2NET (``full_model``) or U2NETP in eval mode on ``device`` (the card
    unless the caller passes ``device="cpu"``), with the checkpoint's weights
    or, without one, weights seeded from ``SEED``."""
    dev = resolve_device(device)
    model = U2NetFull() if full_model else U2NetLite()
    if checkpoint is None:
        print(
            "WARNING: no --checkpoint given; using seeded weights (masks will not be meaningful saliency)",
            file=sys.stderr,
        )
        model.load_state_dict(seeded_state_dict(model, torch.Generator().manual_seed(SEED)))
    else:
        load_u2net_checkpoint(model, checkpoint)
    return model.to(dev).eval()


@functools.lru_cache(maxsize=4)
def _imagenet(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet mean and deviation, f64 [3], uploaded once per device."""
    return (trace.upload(np.asarray(IMAGENET_MEAN), device, "sod.imagenet"),
            trace.upload(np.asarray(IMAGENET_STD), device, "sod.imagenet"))


def preprocess(frames: torch.Tensor, resize_to: tuple[int, int]) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> the network's f32 [B, 3, h, w] input: resized,
    scaled by each image's maximum (a division by a tensor, as numpy divides,
    not by a reciprocal), ImageNet-normalized in f64, then f32."""
    x = resize_images(frames, resize_to).to(torch.float32)
    x = x / x.amax(dim=(1, 2, 3), keepdim=True).clamp_(min=1e-6)
    mean, std = _imagenet(x.device)
    x = ((x.to(torch.float64) - mean) / std).to(torch.float32)
    return x.permute(0, 3, 1, 2).contiguous()


def postprocess(fused: torch.Tensor, frame_hw: tuple[int, int], threshold: float | None) -> torch.Tensor:
    """Fused probabilities f32 [B, 1, h, w] -> uint8 masks [B, H, W] at the
    frames' size: each min-max normalized, binarized at ``threshold`` if
    given, times 255 truncated to uint8, resized bicubically."""
    prob = fused[:, 0]
    lo = prob.amin(dim=(1, 2), keepdim=True)
    prob = (prob - lo) / (prob.amax(dim=(1, 2), keepdim=True) - lo).clamp_(min=1e-8)
    if threshold is not None:
        prob = (prob >= threshold).to(torch.float32)
    return resize_images((prob * 255).to(torch.uint8)[..., None], frame_hw)[..., 0]


def _codec_workers() -> int:
    """Threads for the PNG codec: one per CPU this process may run on."""
    return len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count() or 1


def _frame_batches(frames: Iterable[str | Path], batch_size: int,
                   pool: ThreadPoolExecutor) -> Iterator[tuple[list[Path], np.ndarray]]:
    """Consecutive frames in batches of up to ``batch_size`` frames of one
    size: (paths, uint8 [B, H, W, 3]). A batch's frames are taken from
    ``frames`` and read, all at once on ``pool``, when the batch is asked
    for."""
    frames = iter(frames)
    while chunk := [Path(p) for p in itertools.islice(frames, batch_size)]:
        with trace.span("sod.read"):
            images = list(pool.map(load_color, chunk))
        start = 0
        for end in range(1, len(chunk) + 1):
            if end == len(chunk) or images[end].shape != images[start].shape:
                yield chunk[start:end], np.stack(images[start:end])
                start = end


def masks_for_frames(
    model: U2Net,
    frames: Iterable[str | Path],
    output_folder: str | Path,
    batch_size: int = 16,
    resize_to: tuple[int, int] = (320, 320),
    threshold: float | None = None,
) -> list[Path]:
    """Masks of ``frames`` (colour image paths, read as the loop reaches
    them) by ``model`` on its device, ``batch_size`` frames at a time (a
    partial last batch runs as it is) -> mask PNGs in ``output_folder``
    named by the frames' stems; returns the written paths in order."""
    device = next(model.parameters()).device
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    written: list[Path] = []
    write_mask = functools.partial(write_png, compress_level=MASK_COMPRESS_LEVEL)

    def read_masks(paths: list[Path], masks: torch.Tensor) -> tuple[list[Path], np.ndarray]:
        with trace.blocking("sod.masks"):
            return paths, masks.cpu().numpy()

    def write(paths: list[Path], masks: np.ndarray) -> None:
        out = [output_folder / (path.stem + ".png") for path in paths]
        with trace.span("sod.write"):
            for _ in pool.map(write_mask, out, masks):
                pass  # raises what a write raised
        written.extend(out)
        trace.count("sod.frames", len(paths))

    with ThreadPoolExecutor(_codec_workers(), thread_name_prefix="sod-png") as pool:
        batches = _frame_batches(frames, batch_size, pool)
        trace.item(0)
        batch = next(batches, None)
        pending = None  # the batch before: (paths, uint8 masks on the device)
        i = 0
        while batch is not None:
            paths, rgb = batch
            trace.item(i)
            with trace.span("sod"):
                # the batch before's masks come back before this batch is
                # queued; the pool writes them and reads the next frames
                # while the device runs this batch (not while the host
                # queues it: the codec's threads would slow the launches)
                done = read_masks(*pending) if pending is not None else None
                with trace.span("sod.preprocess"):
                    x = preprocess(trace.upload(rgb, device, "sod.frames"), resize_to)
                with trace.span("sod.forward"), torch.no_grad(), fp32_step():
                    fused = model(x)[0]
                with trace.span("sod.postprocess"):
                    pending = paths, postprocess(fused, rgb.shape[1:3], threshold)
                if done is not None:
                    write(*done)
                batch = next(batches, None)
            trace.count("sod.batches")
            i += 1
        if pending is not None:
            with trace.span("sod"):
                write(*read_masks(*pending))
    return written


def generate_masks(
    input_folder: str | Path,
    output_folder: str | Path,
    checkpoint: str | None = None,
    resize_to: tuple[int, int] = (320, 320),
    threshold: float | None = None,
    full_model: bool = False,
    device=None,
    batch_size: int = 16,
) -> list[Path]:
    """Run SOD over every image in ``input_folder`` -> mask PNGs in
    ``output_folder``; returns the written paths. ``threshold`` binarizes
    (the reference writes greyscale)."""
    dev = resolve_device(device)
    input_folder = Path(input_folder)
    frames = sorted(p for p in input_folder.iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
    if not frames:
        raise FileNotFoundError(f"no images in {input_folder}")
    model = build_model(checkpoint, full_model, dev)
    return masks_for_frames(model, frames, output_folder, batch_size, resize_to, threshold)


def main(argv=None) -> int:
    possible_splits = ["train", "test", "val"]
    parser = argparse.ArgumentParser(
        "Run salient object detection to generate greyscale masks for an RGB image sequence."
    )
    parser.add_argument("-d", "--dataset", type=str, default=".")
    parser.add_argument("-sp", "--split", type=str, default="train")
    parser.add_argument("-si", "--sequence_index", type=int, default=70)
    parser.add_argument("-i", "--input_folder", type=str, default=None)
    parser.add_argument("-o", "--output_folder", type=str, default="sod")
    parser.add_argument("-c", "--checkpoint", type=str, default=None)
    parser.add_argument(
        "--full", action="store_true",
        help="use the full U2NET configuration (for u2net.pth checkpoints; default is U2NETP/lite)",
    )
    parser.add_argument("--threshold", type=float, default=None)
    parser.add_argument("--batch_size", type=int, default=16, help="frames run through the network at once")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.input_folder is not None:
        input_folder = Path(args.input_folder)
        output_folder = (
            Path(args.output_folder)
            if Path(args.output_folder).is_absolute()
            else input_folder.parent / args.output_folder
        )
    else:
        if args.split not in possible_splits:
            raise ValueError(f"--split should be one of {possible_splits}, got {args.split}")
        seq = Path(args.dataset) / args.split / f"seq{args.sequence_index:03d}"
        input_folder = seq / "color"
        output_folder = seq / args.output_folder

    written = generate_masks(
        input_folder, output_folder, args.checkpoint, threshold=args.threshold, full_model=args.full,
        device=args.device, batch_size=args.batch_size,
    )
    print(f"wrote {len(written)} masks to {output_folder}")
    return PROGRAM_EXIT_SUCCESS


if __name__ == "__main__":
    raise SystemExit(main())
