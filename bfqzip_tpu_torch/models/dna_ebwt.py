"""Decoder of "BQZE" DNA-stream containers (EBWT + entropy blob).

Port of bfqzip_tpu/models/dna_ebwt.py::decode_dna_stream, for restoring
archives written by earlier versions: the pipeline no longer writes BQZE,
so the encoder is not ported.  The EBWT is inverted by the port's lf_array
and LF walk on the given device: the card unless the caller asks for the
CPU (a CUDA device without a card raises).

Container "BQZE" v1:
  magic[4] 'BQZE', u8 version, u8 flags, u16 pad
  u32 n_reads, u32 max_len, u64 n (EBWT length), u64 raw_len
  entropy blob of the EBWT string (ASCII A,C,G,T,N,#) — BQZC or BQZR
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from bfqzip_tpu_torch import alphabet
from bfqzip_tpu_torch.engine import resolve_device
from bfqzip_tpu_torch.ops import rans
from bfqzip_tpu_torch.ops.invert import invert
from bfqzip_tpu_torch.ops.rank import lf_array

MAGIC = b"BQZE"


def decode_dna_stream(blob: bytes, device="cuda") -> bytes:
    if blob[:4] != MAGIC:
        raise ValueError("not a bfqzip EBWT container")
    ver, _flags, n_reads, width, n, raw_len = struct.unpack_from("<BBxxIIQQ", blob, 4)
    if ver != 1:
        raise ValueError(f"unsupported BQZE version {ver}")
    dev = resolve_device(device)
    bwt_ascii = np.asarray(rans.decode_blob(blob[32:]))
    if bwt_ascii.size != n:
        raise ValueError(f"BQZE EBWT has {bwt_ascii.size} symbols, header says {n}")

    bwt = alphabet.encode(bwt_ascii)
    n_pad = -(-n // 1024) * 1024
    bwt_p = torch.as_tensor(np.pad(bwt, (0, n_pad - n), constant_values=alphabet.SIGMA))
    bwt_p = bwt_p.to(dev)
    valid = torch.arange(n_pad, dtype=torch.int32, device=bwt_p.device) < n
    lf = lf_array(bwt_p, valid)
    inv = invert(bwt_p, bwt_p, torch.zeros_like(bwt_p), lf, n_reads, width)
    seqs = inv.seqs.cpu().numpy()
    lengths = inv.lengths.cpu().numpy().astype(np.int64)

    out = np.full((n_reads, width + 1), ord("\n"), np.uint8)
    offs = np.arange(width, dtype=np.int64)
    mask = offs[None, :] < lengths[:, None]
    out[:, :width] = np.where(mask, alphabet.decode(seqs[:, :width]), 0)
    # compact: keep per row the first `length` chars + one newline
    keep = np.concatenate([mask, np.ones((n_reads, 1), bool)], axis=1)
    data = out[keep].tobytes()
    if len(data) != raw_len:
        raise ValueError(f"BQZE decoded {len(data)} bytes, header says {raw_len}")
    return data
