"""Image compress / decompress: real files in, real files out (counterpart of
the JAX package's `coding/cli.py`).

PNG -> encoder -> quantized symbols -> context-model rANS stream on disk,
and back. Decompression optionally takes the decoder-side information image
to run the full DSIN path (patch search + siNet fusion); the encoder never
sees it, so the stream is the same with or without it.

The cores work on arrays (`compress_array(x) -> blob`,
`decompress_array(blob, side=None) -> image`); `compress` / `decompress`
wrap them with image files (PIL, imported at use).

File format (little-endian, v3; the JAX package's bytes):
    b"DSIM" | u8 version | u16 img_h | u16 img_w | u32 init_seed
            | u32 crc32 | u32 payload_len | payload
where payload is a BottleneckCodec stream (mode 2, its own header carries
the symbol-volume dims). `crc32` covers every header field after the magic
(except itself) plus the payload, so a flipped bit raises a typed
IntegrityError before any entropy decode; v2 streams (no CRC) stay
readable. `init_seed` is the parameter-init seed the encoder ran with:
decompress rebuilds the model from the header's seed, and an explicit seed
that disagrees with it is an error.

Without a checkpoint the weights come from each package's own seeded init
(a `torch.Generator` here, a JAX PRNG key in the JAX package), so a
seed-only DSIM file decodes only in the package that wrote it; checkpoints
are the cross-package route, and reading them is not ported yet.

Usage:
    python -m dsin_tpu_torch.coding.cli compress x.png out.dsin
    python -m dsin_tpu_torch.coding.cli decompress out.dsin rec.png \
        [--side y.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import struct
import sys
from typing import Optional

import numpy as np
import torch

from dsin_tpu_torch.coding.codec import decode_batch, encode_batch
from dsin_tpu_torch.coding.loader import load_model_state, make_codec
from dsin_tpu_torch.models.quantizer import centers_lookup
from dsin_tpu_torch.ops import sifinder as sifinder_lib
from dsin_tpu_torch.runtime import config_path
from dsin_tpu_torch.utils.integrity import (IntegrityError, frame_crc,
                                            verify_crc)

MAGIC = b"DSIM"
VERSION = 3            # v3: + CRC32 over header fields + payload
HEADER_LEN = 21        # magic(4) + BHH(5) + seed(4) + crc(4) + len(4)
_HEADER_LEN_V2 = 17    # v2: no CRC field
DEFAULT_AE = config_path("ae_kitti_stereo")
DEFAULT_PC = config_path("pc_default")


def frame_dsim(payload: bytes, h: int, w: int, seed: int) -> bytes:
    """Frame a BottleneckCodec payload as a v3 DSIM stream."""
    head = struct.pack("<BHHI", VERSION, h, w, seed)
    tail = struct.pack("<I", len(payload))
    crc = frame_crc(head, tail, payload)
    return MAGIC + head + struct.pack("<I", crc) + tail + payload


def parse_dsim(blob: bytes):
    """-> (version, h, w, seed, payload); every corruption is a typed error.
    v3 verifies the frame CRC (IntegrityError on mismatch); v2 streams
    predate the CRC and parse without one."""
    if len(blob) < _HEADER_LEN_V2 or blob[:4] != MAGIC:
        raise ValueError("not a DSIM stream")
    version = blob[4]
    if version == 2:
        version, h, w, seed, n = struct.unpack("<BHHII",
                                               blob[4:_HEADER_LEN_V2])
        payload = blob[_HEADER_LEN_V2:_HEADER_LEN_V2 + n]
    elif version == VERSION:
        if len(blob) < HEADER_LEN:
            raise ValueError(f"truncated DSIM v3 header: {len(blob)} of "
                             f"{HEADER_LEN} bytes")
        version, h, w, seed, crc, n = struct.unpack("<BHHIII",
                                                    blob[4:HEADER_LEN])
        payload = blob[HEADER_LEN:HEADER_LEN + n]
    else:
        raise ValueError(f"unsupported version {version}")
    if len(payload) != n:
        # the rANS decoder cannot detect truncation itself
        raise ValueError(f"truncated stream: payload {len(payload)} of "
                         f"{n} bytes")
    if version == VERSION:
        verify_crc(crc, "DSIM stream", struct.pack("<BHHI", version, h, w,
                                                   seed),
                   struct.pack("<I", n), payload)
    return version, h, w, seed, payload


def compress_array(x, ae_config: str = DEFAULT_AE,
                   pc_config: str = DEFAULT_PC, ckpt: Optional[str] = None,
                   seed: int = 0, device="cuda") -> bytes:
    """x (H, W, 3) in [0, 255] -> a DSIM blob, on `device` (the card by
    default; raises without one)."""
    x = np.asarray(x, dtype=np.float32)
    h, w, _ = x.shape
    if h % 8 or w % 8:
        raise ValueError(
            f"image {h}x{w} must be divisible by the subsampling factor 8")
    if not 0 <= seed < 2 ** 32:
        # the header stores u32; a masked seed would init other weights on
        # the decode side
        raise ValueError(f"seed must fit u32 (0 <= seed < 2**32), got {seed}")
    model = load_model_state(ae_config, pc_config, ckpt, need_sinet=False,
                             seed=seed, device=device)
    with torch.inference_mode():
        symbols = model.encode(torch.as_tensor(
            x[None], device=model.centers.device)).symbols
    payload = encode_batch(make_codec(model), symbols.cpu().numpy())[0]
    return frame_dsim(payload, h, w, seed)


def decompress_array(blob: bytes, side=None, ae_config: str = DEFAULT_AE,
                     pc_config: str = DEFAULT_PC, ckpt: Optional[str] = None,
                     seed: Optional[int] = None, device="cuda") -> np.ndarray:
    """A DSIM blob -> the reconstruction (H, W, 3) uint8, with the side
    image `side` (H, W, 3) in [0, 255] when given (patch search + siNet).
    `seed=None` takes the stream header's seed; an explicit seed that
    disagrees with it raises."""
    _, h, w, hdr_seed, payload = parse_dsim(blob)
    if seed is None:
        seed = hdr_seed
    elif seed != hdr_seed:
        raise ValueError(
            f"--seed {seed} disagrees with the stream header's init seed "
            f"{hdr_seed}: the encoder ran with seed {hdr_seed}, so any "
            f"other init decodes garbage. Drop --seed to trust the header.")
    model = load_model_state(ae_config, pc_config, ckpt,
                             need_sinet=side is not None, seed=seed,
                             device=device)
    ph, pw = (int(v) for v in model.ae_config.y_patch_size)
    if side is not None:
        # checked before the entropy decode, the slow part
        side = np.asarray(side, dtype=np.float32)
        if h % ph or w % pw:
            raise ValueError(
                f"image {h}x{w} not divisible by y_patch_size ({ph}, {pw});"
                f" the side-information search needs whole patches")
        if side.shape[:2] != (h, w):
            raise ValueError(f"side image {side.shape[:2]} != stream image "
                             f"({h}, {w})")
    symbols = decode_batch(make_codec(model), [payload])   # (1, h/8, w/8, C)
    dev = model.centers.device
    with torch.inference_mode():
        x_dec = model.decode(centers_lookup(
            model.centers, torch.as_tensor(symbols, device=dev)))
        if side is None:
            out = x_dec
        else:
            y = torch.as_tensor(side[None], device=dev)
            y_dec = model.decode(model.encode(y).qbar)
            mask = (torch.as_tensor(sifinder_lib.gaussian_position_mask(
                h, w, ph, pw), device=dev)
                if model.ae_config.use_gauss_mask else None)
            y_syn = sifinder_lib.synthesize_side_image(
                x_dec, y, y_dec, mask, ph, pw, model.ae_config)
            out = model.apply_sinet(x_dec, y_syn)
    return np.clip(out[0].cpu().numpy(), 0, 255).astype(np.uint8)


def read_image(path: str) -> np.ndarray:
    """PNG/JPEG -> (H, W, 3) uint8."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def compress(x_path: str, out_path: str, ae_config: str = DEFAULT_AE,
             pc_config: str = DEFAULT_PC, ckpt: Optional[str] = None,
             seed: int = 0, device="cuda") -> dict:
    x = read_image(x_path)
    blob = compress_array(x, ae_config, pc_config, ckpt, seed, device)
    with open(out_path, "wb") as f:
        f.write(blob)
    h, w, _ = x.shape
    n = len(blob) - HEADER_LEN
    return {"bytes": n, "bpp": n * 8.0 / (h * w), "shape": (h, w)}


def decompress(in_path: str, out_path: str, ae_config: str = DEFAULT_AE,
               pc_config: str = DEFAULT_PC, ckpt: Optional[str] = None,
               side: Optional[str] = None, seed: Optional[int] = None,
               device="cuda") -> dict:
    from PIL import Image
    with open(in_path, "rb") as f:
        blob = f.read()
    img = decompress_array(blob, None if side is None else read_image(side),
                           ae_config, pc_config, ckpt, seed, device)
    Image.fromarray(img).save(out_path)
    return {"shape": img.shape[:2], "with_si": side is not None}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="dsin_tpu_torch image codec. Without --ckpt the weights "
                    "come from this package's seeded init (torch.Generator, "
                    "not the JAX package's PRNG), so a seed-only file "
                    "decodes only in the package that wrote it.")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("compress", "decompress"):
        sp = sub.add_parser(name)
        sp.add_argument("input")
        sp.add_argument("output")
        sp.add_argument("--ae_config", default=DEFAULT_AE)
        sp.add_argument("--pc_config", default=DEFAULT_PC)
        sp.add_argument("--ckpt", default=None,
                        help="checkpoint dir (not ported yet: raises)")
        sp.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    sub.choices["compress"].add_argument(
        "--seed", type=int, default=0,
        help="parameter-init seed, recorded in the stream header (the "
             "weights come from it: no --ckpt)")
    sub.choices["decompress"].add_argument(
        "--seed", type=int, default=None,
        help="assert the stream's init seed (a value disagreeing with the "
             "header is an error; default: trust the header)")
    sub.choices["decompress"].add_argument(
        "--side", default=None,
        help="decoder-side information image (enables the SI path)")
    args = p.parse_args(argv)

    try:
        if args.cmd == "compress":
            info = compress(args.input, args.output, args.ae_config,
                            args.pc_config, args.ckpt, args.seed,
                            args.device)
            print(f"{args.output}: {info['bytes']} bytes, "
                  f"{info['bpp']:.4f} bpp @ {info['shape']}")
        else:
            info = decompress(args.input, args.output, args.ae_config,
                              args.pc_config, args.ckpt, args.side,
                              args.seed, args.device)
            print(f"{args.output}: reconstructed {info['shape']}"
                  f"{' with side information' if info['with_si'] else ''}")
    except IntegrityError as e:
        # a corrupted stream: one line naming the CRC mismatch, exit 2
        print(f"integrity error: {e}", file=sys.stderr)
        raise SystemExit(2)
    except ValueError as e:
        # bad streams and flag/header disagreements are user errors
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2)


if __name__ == "__main__":
    main()
