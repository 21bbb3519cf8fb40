"""EBWT-domain codec for DNA line streams ("BQZE" containers).

Port of bfqzip_tpu/models/dna_ebwt.py: encode_dna_stream builds the EBWT
of the stream's reads with the port's ops/suffix.build_ebwt and
entropy-codes it; decode_dna_stream inverts it with the port's lf_array
and LF walk.  Both run on the given device: the card unless the caller asks
for the CPU (a CUDA device without a card raises).  As in the JAX package,
no pipeline step calls the encoder; the pipeline's --decompress decodes
BQZE archives.

The JAX encoder pads the batch to a compile bucket with inert rows; the
port builds on the unpadded batch.  The container holds only bwt[:n], n,
the read count and the true width, which padding does not change, so the
bytes are the same.

Container "BQZE" v1:
  magic[4] 'BQZE', u8 version, u8 flags, u16 pad
  u32 n_reads, u32 max_len, u64 n (EBWT length), u64 raw_len
  entropy blob of the EBWT string (ASCII A,C,G,T,N,#) — BQZC or BQZR

Eligible streams are newline-terminated lines of A,C,G,T,N (what step 4
writes); encode_dna_stream returns None otherwise.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

from bfqzip_tpu_torch import alphabet
from bfqzip_tpu_torch.utils.profiling import resolve_device
from bfqzip_tpu_torch.ops import rans
from bfqzip_tpu_torch.ops.invert import invert
from bfqzip_tpu_torch.ops.rank import lf_array
from bfqzip_tpu_torch.ops.suffix import build_ebwt

MAGIC = b"BQZE"

_ELIGIBLE = np.zeros(256, bool)
_ELIGIBLE[list(b"ACGTN")] = True


def encode_dna_stream(data: bytes, device="cuda") -> Optional[bytes]:
    """EBWT + entropy-code a '\\n'-joined DNA line stream; None if ineligible."""
    if len(data) == 0 or data[-1:] != b"\n":
        return None
    buf = np.frombuffer(data, np.uint8)
    nl = np.flatnonzero(buf == ord("\n"))
    starts = np.concatenate(([0], nl[:-1] + 1))
    lengths = (nl - starts).astype(np.int64)
    if lengths.size == 0 or (lengths == 0).any():
        return None
    if not _ELIGIBLE[np.delete(buf, nl)].all():
        return None
    dev = resolve_device(device)

    n_reads = int(lengths.size)
    width = int(lengths.max())
    offs = np.arange(width, dtype=np.int64)
    idx = np.minimum(starts[:, None] + offs[None, :], buf.size - 1)
    mask = offs[None, :] < lengths[:, None]
    seqs = np.zeros((n_reads, width), np.uint8)
    seqs[mask] = alphabet.encode(buf[idx][mask])

    seqs_t = torch.as_tensor(seqs).to(dev)
    ebwt = build_ebwt(seqs_t, torch.zeros_like(seqs_t), torch.as_tensor(lengths.astype(np.int32)).to(dev))
    n = int(ebwt.n)
    bwt_ascii = alphabet.decode(ebwt.bwt[:n].cpu().numpy())
    blob = rans.encode_blob_best(bwt_ascii.tobytes())
    header = MAGIC + struct.pack("<BBxxIIQQ", 1, 0, n_reads, width, n, len(data))
    return header + blob


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
