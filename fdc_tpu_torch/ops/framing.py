"""Overlap-save framing: stream -> overlapped FFT blocks, batched.

Port of ``fdc_tpu.ops.framing.frame_blocks`` (reference:
lib/overlap_save_impl.cc:62-81): block b of a batch covers samples
[b*inplen - ovllen, (b+1)*inplen) of the extended stream, the first
``ovllen`` of them carried over from the previous batch as history.
"""

from __future__ import annotations

import torch

__all__ = ["frame_blocks"]


def frame_blocks(x: torch.Tensor, hist: torch.Tensor, blocksize: int):
    """Frame a flat sample batch into overlapped blocks.

    Args:
      x: [B * inplen] new samples, inplen = blocksize - len(hist).
      hist: [ovllen] trailing samples of the previous batch.

    Returns (blocks [B, blocksize], new_hist [ovllen]).
    """
    ovllen = hist.shape[0]
    inplen = blocksize - ovllen
    total = x.shape[0]
    if total % inplen:
        raise ValueError(
            f"sample count {total} must be a multiple of inplen={inplen}"
        )
    nblocks = total // inplen
    # relinvovl >= 2, so each block's history prefix is the tail of the
    # previous block's input run: framing is pure layout, no gather
    xr = x.reshape(nblocks, inplen)
    tails = xr[:, inplen - ovllen:]  # [B, ovllen]
    prev = torch.cat([hist[None], tails[:-1]], dim=0)
    blocks = torch.cat([prev, xr], dim=1)
    return blocks, tails[-1].clone()
