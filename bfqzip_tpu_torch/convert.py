"""Carry state between numpy (and so the JAX package) and the port's tensors.

There are no weights: the EBWT is the state.  `ebwt_from_numpy` takes the
seven EbwtDevice fields as numpy arrays (for example np.asarray of each
field of a bfqzip_tpu EbwtDevice) and `ebwt_to_numpy` gives them back.
"""

from __future__ import annotations

import numpy as np
import torch

from bfqzip_tpu_torch.io.fastq import ReadBatch
from bfqzip_tpu_torch.ops.suffix import EbwtDevice

_DTYPES = {
    "bwt": torch.uint8,
    "qs": torch.uint8,
    "lcp": torch.int32,
    "sa": torch.int32,
    "text": torch.uint8,
    "n": torch.int32,
    "pre": torch.uint8,
}


def ebwt_from_numpy(fields: dict, device) -> EbwtDevice:
    """All seven fields are required (the flat build's EBWT carries `pre`)."""
    return EbwtDevice(**{
        name: torch.tensor(np.asarray(fields[name]), dtype=dtype, device=device)  # a copy
        for name, dtype in _DTYPES.items()
    })


def ebwt_to_numpy(ebwt: EbwtDevice) -> dict:
    return {name: getattr(ebwt, name).cpu().numpy() for name in _DTYPES}


def batch_to_tensors(batch: ReadBatch, device) -> tuple:
    """(seqs [N, L] u8, quals [N, L] u8, lengths [N] i32) on `device`."""
    return (
        torch.as_tensor(np.ascontiguousarray(batch.seqs, np.uint8)).to(device),
        torch.as_tensor(np.ascontiguousarray(batch.quals, np.uint8)).to(device),
        torch.as_tensor(np.ascontiguousarray(batch.lengths, np.int32)).to(device),
    )
