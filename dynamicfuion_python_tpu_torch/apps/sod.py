"""Salient-object-detection masks for RGB sequences (port of
``dynamicfuion_python_tpu/apps/sod.py``).

Walks a DeepDeform split / sequence (or a given input folder), runs U²-Net
(``models/u2net.py``) on each colour frame and writes a greyscale saliency
mask (0-255 PNG, the frame's stem) into the ``sod`` folder the fusion data
layer reads for background subtraction.

Per frame, as the JAX package does it: the frame resized to 320x320 by
Pillow's bicubic filter (``data/images.py::resize_bicubic``, bit-equal,
without Pillow), scaled by its maximum and normalized with the ImageNet mean
and deviation; the fused output min-max normalized, quantized to uint8,
resized back to the frame's size bicubically and written by
``utils/telemetry.py::write_png``. PNG frames need no Pillow; a JPEG frame
does. The forward runs with TF32 off for cuBLAS and cuDNN.

``--checkpoint`` is an original-release ``u2net.pth`` / ``u2netp.pth``
(``--full`` for the big model), an ``.npz`` of Flax variables flattened with
"/" or a Flax msgpack file. Without one the weights are seeded (only useful
to exercise the pipeline) and a warning is printed.

Run: python -m dynamicfuion_python_tpu_torch.apps.sod (-i <folder> |
        -d <root> -sp train -si 70) [-o sod] [-c <checkpoint>] [--full]
        [--threshold t] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.apps.train import fp32_step
from dynamicfuion_python_tpu_torch.data.images import load_color, resize_bicubic
from dynamicfuion_python_tpu_torch.models.torch_weight_conversion import load_u2net_checkpoint
from dynamicfuion_python_tpu_torch.models.u2net import U2Net, U2NetFull, U2NetLite, seeded_state_dict
from dynamicfuion_python_tpu_torch.utils.device import resolve_device
from dynamicfuion_python_tpu_torch.utils.telemetry import write_png

PROGRAM_EXIT_SUCCESS = 0
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406])
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225])
SEED = 0


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


def preprocess(rgb: np.ndarray, resize_to: tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, 3] -> the network's f32 [1, 3, h, w] input: resized,
    scaled by the per-image maximum, ImageNet-normalized (in f64, then
    f32, as the JAX package's numpy does it)."""
    arr = resize_bicubic(rgb, resize_to).astype(np.float32)
    arr = arr / max(float(arr.max()), 1e-6)
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return np.ascontiguousarray(arr.astype(np.float32).transpose(2, 0, 1)[None])


def mask_from_probability(prob: np.ndarray, frame_hw: tuple[int, int], threshold: float | None) -> np.ndarray:
    """Fused probability f32[h, w] -> uint8 mask at the frame's size."""
    prob = (prob - prob.min()) / max(prob.max() - prob.min(), 1e-8)
    if threshold is not None:
        prob = (prob >= threshold).astype(np.float32)
    return resize_bicubic((prob * 255).astype(np.uint8), frame_hw)


def generate_masks(
    input_folder: str | Path,
    output_folder: str | Path,
    checkpoint: str | None = None,
    resize_to: tuple[int, int] = (320, 320),
    threshold: float | None = None,
    full_model: bool = False,
    device=None,
) -> list[Path]:
    """Run SOD over every image in ``input_folder`` -> mask PNGs in
    ``output_folder``; returns the written paths. ``threshold`` binarizes
    (the reference writes greyscale)."""
    dev = resolve_device(device)
    input_folder = Path(input_folder)
    output_folder = Path(output_folder)
    frames = sorted(p for p in input_folder.iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
    if not frames:
        raise FileNotFoundError(f"no images in {input_folder}")
    output_folder.mkdir(parents=True, exist_ok=True)
    model = build_model(checkpoint, full_model, dev)
    written = []
    for frame in frames:
        rgb = load_color(frame)
        x = torch.as_tensor(preprocess(rgb, resize_to), device=dev)
        with torch.no_grad(), fp32_step():
            prob = model(x)[0][0, 0].cpu().numpy()
        out_path = output_folder / (frame.stem + ".png")
        write_png(out_path, mask_from_probability(prob, rgb.shape[:2], threshold))
        written.append(out_path)
    return written


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
        device=args.device,
    )
    print(f"wrote {len(written)} masks to {output_folder}")
    return PROGRAM_EXIT_SUCCESS


if __name__ == "__main__":
    raise SystemExit(main())
