"""The pack kernel of ``score_many``'s buckets, and its plain version.

``pack_rows(flat, off, lens, width, fill)`` writes one side of a bucket:
row r holds ``flat[off[r] : off[r] + lens[r]]`` and ``fill`` after it, to
``width`` bytes. ``flat`` is every distinct sequence of a call once,
concatenated; ``off`` and ``lens`` are int32 rows of the call's tables, on
``flat``'s device. On a card it runs the C entry ``sw_pack_rows``
(``csrc/pack_rows.cu``: a thread an aligned 16-byte chunk of a row, width a
multiple of 16); on the CPU its plain version, ``pack_rows_plain``.
``launches`` and ``plain_calls`` count them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import stripe_fill as sf

PACK_KERNEL = "sw_pack_rows"
launches = {PACK_KERNEL: 0}
plain_calls = {"pack_rows_plain": 0}


def _check(flat, off, lens, width: int) -> None:
    if flat.dtype != torch.int8 or flat.dim() != 1:
        raise ValueError(f"flat must be a 1-D int8 tensor, got {flat.dtype} "
                         f"{tuple(flat.shape)}")
    if off.dtype != torch.int32 or lens.dtype != torch.int32 \
            or off.shape != lens.shape or off.dim() != 1:
        raise ValueError("off and lens must be int32 vectors of one length")
    if not flat.device == off.device == lens.device:
        raise ValueError("flat, off and lens must be on one device")
    if width <= 0:
        raise ValueError(f"width must be positive, got {width}")


def pack_rows(flat: torch.Tensor, off: torch.Tensor, lens: torch.Tensor,
              width: int, fill: int) -> torch.Tensor:
    """The (rows, width) int8 codes of one side of a bucket, on ``flat``'s
    device: each row's bytes of ``flat``, then ``fill``. Each row must lie
    inside ``flat`` and fit ``width``."""
    _check(flat, off, lens, width)
    if flat.device.type == "cpu":
        return pack_rows_plain(flat, off, lens, width, fill)
    if flat.device.type != "cuda":
        raise ValueError(f"no pack kernel for device {flat.device}")
    return _launch_pack(flat, off, lens, width, fill)


def _launch_pack(flat, off, lens, width: int, fill: int) -> torch.Tensor:
    """``sw_pack_rows`` on ``flat``'s device; width a multiple of 16."""
    if width % 16:
        raise ValueError(f"the pack kernel writes 16-byte chunks: width "
                         f"{width} is no multiple of 16")
    off, lens = off.contiguous(), lens.contiguous()
    out = torch.empty((off.shape[0], width), dtype=torch.int8,
                      device=flat.device)
    sf._call(PACK_KERNEL, flat.device,
             [flat.data_ptr(), off.data_ptr(), lens.data_ptr(), off.shape[0],
              width, fill, out.data_ptr()], None, launches)
    return out


def pack_rows_plain(flat: torch.Tensor, off: torch.Tensor,
                    lens: torch.Tensor, width: int,
                    fill: int) -> torch.Tensor:
    """Plain version of ``sw_pack_rows``, on the CPU: a buffer of ``fill``
    and a row copy a row."""
    plain_calls["pack_rows_plain"] += 1
    out = np.full((off.shape[0], width), fill, np.int8)
    src = flat.numpy()
    for r, (o, n) in enumerate(zip(off.tolist(), lens.tolist())):
        out[r, :n] = src[o:o + n]
    return torch.from_numpy(out)
