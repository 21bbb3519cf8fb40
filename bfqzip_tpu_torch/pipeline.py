"""End-to-end pipeline of the port, with durable, resumable stage artifacts.

Port of bfqzip_tpu/pipeline.py: the same stages, artifacts and output bytes
(see that module's docstring), with steps 1 and 3 on the port's engine on an
explicit torch device and the host codecs on the port's jax-free rANS:

  step 1  EBWT + QS permutation (+ LCP)  -> OUT.bwt, OUT.bwt.qs, OUT.lcp, OUT.meta.json
  step 2  headers                        -> OUT.h
  step 3  smooth + LF-walk inversion     -> OUT.fq
  step 4  stream split (modes 2/3)       -> OUT.fq.dna, OUT.fq.qs
  step 5  entropy coding                 -> <stream>.rans (and .7z / .bsc when
                                            those binaries exist)

Block mode (-t) runs one block per rank when there are enough devices
(cards on CUDA, cores for gloo ranks on the CPU) and the blocks are equal,
as the JAX pipeline's mesh route does (parallel/block.py); otherwise one
block after another on the device.  Out-of-core (`ext_mem_mb`) fuses steps
1-3 in external.smooth_fastq_external under a device-memory budget, as the
JAX pipeline does, and skips the artifacts.  So does the sequence-sharded
route (`mesh_shards` > 1): ONE global EBWT over that many ranks
(parallel/global_pipeline.py), one card each on CUDA, gloo ranks on the CPU.

Every route hands back its smoothed reads in input order and writes no
.fq; one writer (_write_smoothed) formats them once, and steps 4-5 cut the
streams and the paired _1/_2 halves from the bytes it formatted.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from bfqzip_tpu_torch import alphabet
from bfqzip_tpu_torch.config import PipelineConfig
from bfqzip_tpu_torch.io.fastq import ReadBatch, fastq_array, read_fastq
from bfqzip_tpu_torch.utils import native
from bfqzip_tpu_torch.convert import batch_to_tensors
from bfqzip_tpu_torch.engine import smooth_arrays_step, smooth_fastq
from bfqzip_tpu_torch.ops import rans
from bfqzip_tpu_torch.ops.suffix import build_ebwt
from bfqzip_tpu_torch.parallel import mesh
from bfqzip_tpu_torch.utils.logging import StepLogger
from bfqzip_tpu_torch.utils.profiling import resolve_device, span

ZIP7 = shutil.which("7z")
BSC = shutil.which("bsc")


@dataclasses.dataclass
class PipelineResult:
    streams: List[str]
    outputs: Dict[str, List[str]]  # codec -> files
    stats: Dict[str, int]
    report: Dict[str, object]  # sizes/ratios + per-phase wall/memory records


def _meta_path(base):
    return base + ".meta.json"


def _fingerprint(batch: ReadBatch) -> str:
    """Identity of the stage-1 input: the exact read content (the cache is
    valid only while the hash recorded in meta.json matches)."""
    with span("pipeline.fingerprint"):
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(batch.seqs).tobytes())
        h.update(np.ascontiguousarray(batch.quals).tobytes())
        h.update(np.ascontiguousarray(batch.lengths).tobytes())
        return h.hexdigest()


def _recorded_fingerprint(base: str) -> Optional[str]:
    """The fingerprint in meta.json when every stage-1 artifact exists at
    `base`, else None."""
    if not all(
        os.path.exists(base + ext) for ext in (".bwt", ".bwt.qs", ".lcp", ".meta.json")
    ):
        return None
    try:
        with open(_meta_path(base)) as f:
            return json.load(f).get("fingerprint")
    except (OSError, ValueError):
        return None


def step1_build(batch: ReadBatch, base: str, log: StepLogger, device,
                fingerprint: Optional[str] = None):
    """EBWT + QS + LCP artifacts.  The batch is built as it is: the JAX
    package's compile-shape padding rows are inert, so the artifacts are the
    same bytes.  The step's time includes writing them.  meta.json records
    `fingerprint`, the batch's _fingerprint, hashed here when not given.
    Returns step 3's input as load_artifacts would read it back from these
    files, kept on the card (`_held_arrays`)."""
    with log.step("step1: EBWT+QS+LCP construction"):
        ebwt = build_ebwt(*batch_to_tensors(batch, device))
        n = int(ebwt.n)
        held = _held_arrays(ebwt, n)
        bwt = ebwt.bwt[:n].cpu().numpy()
        qs = ebwt.qs[:n].cpu().numpy()
        lcp = ebwt.lcp[:n].cpu().numpy()
        del ebwt
        meta = {"n": n, "n_reads": batch.num_reads, "max_len": batch.max_len,
                "fingerprint": fingerprint or _fingerprint(batch)}
        for ext, data in ((".bwt", alphabet.decode(bwt)), (".bwt.qs", qs), (".lcp", lcp.astype("<u2"))):
            _write(base + ext, data.tobytes())
        with span("pipeline.write"), open(_meta_path(base), "w") as f:
            json.dump(meta, f)
    return held, meta


def _write(path: str, data) -> None:
    with span("pipeline.write"), open(path, "wb") as f:
        f.write(data)


def _write_smoothed(batch: ReadBatch, smoothed: ReadBatch, base: str, headers) -> np.ndarray:
    """The one writer of BASE.fq: `smoothed`, a route's reads for `batch` in
    input order, formatted once with `headers` (None: bare '@' lines).
    Returns the .fq's bytes, which steps 4 and the paired re-split cut."""
    if smoothed.num_reads != batch.num_reads:
        raise ValueError(f"{smoothed.num_reads} smoothed reads for {batch.num_reads} parsed")
    with span("pipeline.format_fastq"):
        data = fastq_array(smoothed, headers=headers)
    _write(base + ".fq", data)
    return data


def _line_starts(data):
    """A FASTQ body as a u8 array and the offsets where its lines start:
    line i of data.split(b"\\n") is buf[starts[i]:starts[i + 1] - 1], and the
    last line, which no newline ends, is buf[starts[-1]:]."""
    buf = np.frombuffer(data, np.uint8)
    return buf, np.concatenate(([0], np.flatnonzero(buf == ord("\n")) + 1))


def _every_fourth(buf: np.ndarray, starts: np.ndarray, first: int):
    """b"\\n".join(lines[first::4]) + b"\\n" of the body's lines: each kept
    line with its newline, one appended where none follows."""
    keep = np.zeros(len(starts), bool)
    keep[first::4] = True
    out = buf[np.repeat(keep, np.diff(starts, append=len(buf)))]
    return np.append(out, np.uint8(ord("\n"))) if keep[-1] or not keep.any() else out


def _padded(n: int) -> int:
    """Step 3's array length for n positions: the next multiple of 1024."""
    return ((n + 1023) // 1024) * 1024


def _held_arrays(ebwt, n: int):
    """load_artifacts' arrays made on the card from the build: bwt, qs and
    lcp cut to n and padded to a multiple of 1024 with bwt=SIGMA, qs=0,
    lcp=0, lcp as the .lcp file's <u2 gives it back, and n."""
    with span("pipeline.load_artifacts"):
        size = _padded(n)
        dev = ebwt.bwt.device
        bwt = torch.full((size,), alphabet.SIGMA, dtype=torch.uint8, device=dev)
        bwt[:n] = ebwt.bwt[:n]
        qs = torch.zeros(size, dtype=torch.uint8, device=dev)
        qs[:n] = ebwt.qs[:n]
        lcp = torch.zeros(size, dtype=torch.int32, device=dev)
        torch.bitwise_and(ebwt.lcp[:n], 0xFFFF, out=lcp[:n])
        return bwt, qs, lcp, torch.tensor(n, dtype=torch.int32, device=dev)


def load_artifacts(base: str, device):
    """The stage-1 artifacts as ((bwt, qs, lcp, n), meta): the arrays on
    `device`, padded to a multiple of 1024 with bwt=SIGMA, qs=0, lcp=0, and
    n a 0-d int32 tensor there."""
    with span("pipeline.load_artifacts"):
        with open(_meta_path(base)) as f:
            meta = json.load(f)
        n = meta["n"]
        pad = _padded(n) - n
        bwt = np.pad(alphabet.encode(np.fromfile(base + ".bwt", np.uint8)), (0, pad),
                     constant_values=alphabet.SIGMA)
        qs = np.pad(np.fromfile(base + ".bwt.qs", np.uint8), (0, pad))
        lcp = np.pad(np.fromfile(base + ".lcp", "<u2").astype(np.int32), (0, pad))
        arrays = tuple(torch.as_tensor(a).to(device) for a in (bwt, qs, lcp))
        return (*arrays, torch.tensor(n, dtype=torch.int32, device=device)), meta


def step3_smooth(base: str, cfg: PipelineConfig, log: StepLogger, device, debug_dump: bool = False,
                 held=None):
    """Cluster smoothing + inversion from the stage-1 artifacts: `held`,
    step1_build's return when step 1 ran in this call, else load_artifacts
    reads them from the files.  The span `pipeline.load_artifacts` times
    either route: the on-card cut and pad in step 1, or the file reads."""
    (bwt, qs, lcp, n_t), meta = held if held is not None else load_artifacts(base, device)
    n = meta["n"]
    with log.step("step3: cluster smoothing + inversion"):
        inv, bwt_sub, qs_new, stats = smooth_arrays_step(
            bwt, qs, lcp, n_t, meta["n_reads"], meta["max_len"], cfg.smooth
        )
        out = ReadBatch(
            seqs=inv.seqs.cpu().numpy(),
            quals=inv.quals.cpu().numpy(),
            lengths=inv.lengths.cpu().numpy(),
        )

    if debug_dump:
        # reference -D/-V inspection outputs (bfq_int.cpp:829-862,1022-1053)
        from bfqzip_tpu_torch.utils import debug as dbg

        bwt, qs, lcp = (a[:n].cpu().numpy() for a in (bwt, qs, lcp))
        bwt_sub_h = bwt_sub[:n].cpu().numpy()
        qs_new_h = qs_new[:n].cpu().numpy()
        with open(base + ".debug.tsv", "w") as f:
            dbg.position_dump(bwt, bwt_sub_h, qs, qs_new_h, lcp, cfg.smooth, f)
        nonterm = bwt != 0
        log.info("QS distribution before: " + str(dbg.qs_distribution(qs, nonterm)))
        log.info("QS distribution after:  " + str(dbg.qs_distribution(qs_new_h, nonterm)))
        hist = dbg.cluster_size_histogram(lcp, cfg.smooth)
        log.info("cluster-size histogram:\n" + dbg.format_histogram(hist))

    return out, {k: int(v) for k, v in stats.items()}


def _rans_one(path: str) -> str:
    data = open(path, "rb").read()
    if path.endswith(".h"):
        # tokenising header model (models/headers.py)
        from bfqzip_tpu_torch.models.headers import encode_headers

        blob = encode_headers(data.split(b"\n")[:-1])
    else:
        # quality streams get BQZC's positional contexts: the in-read
        # position (reset at each newline) strongly conditions q
        pos_reset = ord("\n") if path.endswith(".qs") else -1
        blob = rans.encode_blob_best(data, pos_reset=pos_reset)
    out = path + ".rans"
    with open(out, "wb") as f:
        f.write(blob)
    return out


def step5_compress(streams: List[str], codecs, log: StepLogger) -> Dict[str, List[str]]:
    """Entropy-code every stream with each backend.  The in-tree coder runs
    the streams concurrently (the native encode releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    outputs: Dict[str, List[str]] = {}
    for codec in codecs:
        outs = []
        if codec == "rans" and streams:
            with log.step("step5: rans " + " ".join(os.path.basename(p) for p in streams)):
                with ThreadPoolExecutor(max_workers=min(len(streams), 8)) as tp:
                    outs.extend(tp.map(_rans_one, streams))
            outputs[codec] = outs
            continue
        for path in streams:
            if codec == "ppmd" and ZIP7:
                out = path + ".7z"
                if os.path.exists(out):
                    os.remove(out)
                with log.step(f"step5: 7z PPMd {os.path.basename(path)}"):
                    log.run([ZIP7, "a", "-mm=PPMd", out, path])
            elif codec == "bsc" and BSC:
                out = path + ".bsc"
                with log.step(f"step5: bsc {os.path.basename(path)}"):
                    log.run([BSC, "e", path, out, "-T"])
            else:
                continue  # backend unavailable
            outs.append(out)
        if outs:
            outputs[codec] = outs
    return outputs


def _pair_paths(out_path: str):
    """BASE.fastq -> (BASE_1.fastq, BASE_2.fastq), extension preserved."""
    root, ext = os.path.splitext(out_path)
    return root + "_1" + ext, root + "_2" + ext


def _split_pair(data, n1: int):
    """Split a merged FASTQ body (file-1 records then file-2 records) just
    past its 4*n1-th newline: the mate boundary of compression and restore."""
    starts = _line_starts(data)[1]
    if 4 * n1 >= len(starts):
        raise ValueError(f"merged archive has fewer than {n1} file-1 records")
    return data[:starts[4 * n1]], data[starts[4 * n1]:]


def _write_pair(out_path: str, body: bytes, n1: int):
    p1, p2 = _pair_paths(out_path)
    half1, half2 = _split_pair(body, n1)
    with open(p1, "wb") as f:
        f.write(half1)
    with open(p2, "wb") as f:
        f.write(half2)
    return p1, p2


def restore_fastq(base: str, out_path: Optional[str] = None, device="cuda"):
    """Reassemble a FASTQ from compressed stream containers.

    Mode-1 archives (BASE.fq.rans) decode directly; mode-2/3 archives
    interleave BASE.fq.dna.rans + BASE.fq.qs.rans with BASE.h.rans headers
    when present ('@' otherwise).  Paired archives (BASE.paired.meta.json
    present) restore to a _1/_2 FASTQ pair.  Returns the single output path,
    or the (path_1, path_2) tuple for paired archives.  `device` inverts a
    BQZE stream's EBWT (see decompress_stream).
    """
    out_path = out_path or base + ".restored.fastq"
    paired_n1 = None
    meta_p = _meta_path(base + ".paired")
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            paired_n1 = int(json.load(f)["reads_file1"])

    # paired mode 1: one archive per mate file
    if paired_n1 is not None and os.path.exists(base + "_1.fq.rans"):
        p1, p2 = _pair_paths(out_path)
        for path, arc in ((p1, base + "_1.fq.rans"), (p2, base + "_2.fq.rans")):
            if not os.path.exists(arc):
                raise FileNotFoundError(f"paired archive missing: {arc}")
            with open(path, "wb") as f:
                f.write(_decode_blob_file(arc, device))
        return p1, p2

    one = base + ".fq.rans"
    if os.path.exists(one):
        data = _decode_blob_file(one, device)
        if paired_n1 is not None:  # merged archive of a paired run
            return _write_pair(out_path, data, paired_n1)
        with open(out_path, "wb") as f:
            f.write(data)
        return out_path
    dna_p, qs_p, h_p = base + ".fq.dna.rans", base + ".fq.qs.rans", base + ".h.rans"
    if not (os.path.exists(dna_p) and os.path.exists(qs_p)):
        raise FileNotFoundError(f"no stream archives found at {base}(.fq|.fq.dna|.fq.qs).rans")
    dna = _decode_blob_file(dna_p, device).split(b"\n")
    qs = _decode_blob_file(qs_p, device).split(b"\n")
    if dna and dna[-1] == b"":
        dna.pop()
    if qs and qs[-1] == b"":
        qs.pop()
    if len(dna) != len(qs):
        raise ValueError(f"stream record mismatch: {len(dna)} DNA vs {len(qs)} QS lines")
    if os.path.exists(h_p):
        headers = _decode_blob_file(h_p, device).split(b"\n")
        if headers and headers[-1] == b"":
            headers.pop()
        if len(headers) != len(dna):
            raise ValueError(f"{len(headers)} headers for {len(dna)} records")
    else:
        headers = None
    parts = []
    for i, (d, q) in enumerate(zip(dna, qs)):
        parts += [headers[i] if headers else b"@", b"\n", d, b"\n+\n", q, b"\n"]
    body = b"".join(parts)
    if paired_n1 is not None:
        return _write_pair(out_path, body, paired_n1)
    with open(out_path, "wb") as f:
        f.write(body)
    return out_path


def _decode_blob_file(path: str, device) -> bytes:
    tmp = decompress_stream(path, path + ".dec.tmp", device)
    with open(tmp, "rb") as f:
        data = f.read()
    os.remove(tmp)
    return data


def decompress_stream(path: str, out_path: Optional[str] = None, device="cuda") -> str:
    """Decode any bfqzip container back to the original stream bytes.  The
    header and rANS containers decode on the host; a BQZE archive inverts
    its EBWT on `device` (a CUDA device without a card raises)."""
    blob = open(path, "rb").read()
    if blob[:4] == b"BQZH":
        from bfqzip_tpu_torch.models.headers import decode_headers

        payload = b"\n".join(decode_headers(blob)) + b"\n"
    elif blob[:4] == b"BQZE":
        from bfqzip_tpu_torch.models.dna_ebwt import decode_dna_stream

        payload = decode_dna_stream(blob, device)
    elif blob[:4] == b"BQZC":
        payload = rans.decode_blob(blob).tobytes()
    elif native.available():
        payload = native.rans_decode(blob).tobytes()
    else:
        payload = rans.decode(blob).tobytes()
    out_path = out_path or (path[:-5] if path.endswith(".rans") else path + ".out")
    with open(out_path, "wb") as f:
        f.write(payload)
    return out_path


def run_pipeline(
    inputs: List[str],
    cfg: PipelineConfig,
    out_base: Optional[str] = None,
    check: bool = False,
    reorder: int = 0,
    blocks: int = 0,
    mesh_shards: int = 0,
    ext_mem_mb: int = 0,
    logfile: Optional[str] = None,
    debug_dump: bool = False,
    device="cuda",
) -> PipelineResult:
    """The full compression pipeline on `device` (a CUDA device without a
    card raises, and so does a CUDA `mesh_shards` above the card count)."""
    device = resolve_device(device)
    sharded = mesh_shards > 1 and not cfg.original and not ext_mem_mb  # --ext-mem goes first
    if sharded:
        mesh.check_world(mesh_shards, device)
    base = out_base or inputs[0]
    log = StepLogger(logfile or base + ".log", device)
    log.command_line()

    # ---- input / validation (checkFASTQ.py semantics via the parser) ----
    spill = None
    with log.step("read FASTQ"):
        if ext_mem_mb and len(inputs) == 1 and not cfg.original:
            # out-of-core runs parse in record-aligned slabs straight into
            # spill-backed arrays, so the input never needs twice its size
            # of host RAM
            from bfqzip_tpu_torch.io.spill import Spill, read_fastq_spill

            spill = Spill()
            batches = [read_fastq_spill(inputs[0], spill, with_headers=True)]
        else:
            batches = [read_fastq(p) for p in inputs]
    if check:
        for b in batches:
            b.validate()
        log.info("checkFASTQ: valid")

    paired_split = batches[0].num_reads if len(batches) > 1 else None

    # ---- optional reorder: in paired mode ONE permutation, computed on
    # file 1, is applied to both mate files, so mates stay aligned ----
    if reorder:
        from bfqzip_tpu_torch.utils.reorder import reorder_batch

        with log.step(f"reorder mode {reorder}"):
            if len(batches) > 1:
                b1, b2 = reorder_batch(batches[0], mode=reorder, mate=batches[1])
                batches = [b1, b2]
            else:
                batches = [reorder_batch(batches[0], mode=reorder)]

    batch = batches[0] if len(batches) == 1 else _concat(batches)
    headers = batch.headers if (cfg.headers or cfg.mode == 3) else None

    # ---- steps 1-3: one route hands back the smoothed reads in input order
    # (none under --original); step 2 writes the .h, and the one writer the
    # .fq, before the out-of-core route's spill files close ----
    extra: Dict[str, object] = {}
    fq = None
    try:
        if ext_mem_mb and not cfg.original:
            # chunked device sorts + native host merge + streaming smoothing
            # under a device-memory budget
            from bfqzip_tpu_torch.external import smooth_fastq_external

            extra["external"] = {}  # chunk / segment counts, stage seconds and RSS
            with log.step(f"steps1-3: external memory, budget {ext_mem_mb} MB"):
                smoothed, stats = smooth_fastq_external(
                    batch, cfg.smooth, mem_bytes=ext_mem_mb << 20, device=device, spill=spill,
                    report=extra["external"],
                )
        elif sharded:
            # ONE global EBWT over mesh_shards ranks spawned from this process
            from bfqzip_tpu_torch.parallel import smooth_fastq_sharded

            extra["sharded"] = []  # per rank: attempts, stage ms, bytes
            with log.step(f"steps1-3: sequence-sharded over {mesh_shards} ranks"):
                smoothed, stats = smooth_fastq_sharded(
                    batch, cfg.smooth, shards=mesh_shards, device=device,
                    work_dir=os.path.dirname(os.path.abspath(base)), reports=extra["sharded"],
                )
        else:
            smoothed, stats = _in_memory(batch, base, cfg, log, device, blocks, paired_split,
                                         debug_dump, extra)
        if headers is not None:
            _write(base + ".h", b"\n".join(headers) + b"\n")
        if cfg.original:
            with log.step("step3: --original (copy input)"):
                shutil.copyfile(inputs[0], base + ".fq")
        else:
            fq = _write_smoothed(batch, smoothed, base, headers)
            if paired_split is None and cfg.mode not in (2, 3):
                fq = None  # no step cuts them: not held through step 5 or the spill's close
    finally:
        if spill is not None:
            spill.close()

    result = _finish_pipeline(inputs, cfg, base, log, stats, paired_split, fq)
    result.report.update(extra)
    return result


def _in_memory(batch, base, cfg, log, device, blocks, paired_split, debug_dump, extra):
    """Steps 1 and 3 with the stage-1 artifacts cached by content: the batch
    is hashed only when artifacts exist to check, and that digest goes into
    a rebuild's meta.json.  Step 3 takes the arrays of a step 1 run in this
    call on the card.  Block mode builds each block afresh and writes no
    artifacts.  Returns the smoothed reads in input order (None where
    --original skips step 3) and the stats."""
    recorded = None if cfg.rebuild else _recorded_fingerprint(base)
    digest = None if recorded is None else _fingerprint(batch)
    held = None
    if digest is not None and digest == recorded:
        log.info("step1: artifacts cached, skipping (use rebuild to force)")
    elif blocks > 1:
        return _blockwise_step1_3(batch, base, cfg, blocks, log, device, paired_split), {}
    else:
        held = step1_build(batch, base, log, device, digest)
    if cfg.original:
        return None, {}
    extra["step3_input"] = "files" if held is None else "held"  # "held": step 1's arrays on the card
    return step3_smooth(base, cfg, log, device, debug_dump=debug_dump, held=held)


def _finish_pipeline(inputs, cfg, base, log, stats, paired_split, fq) -> PipelineResult:
    """Steps 4-5 + report.  `fq` is the .fq's bytes as the writer formatted
    them; under --original it is None, and step 4 reads the copied file."""
    # paired mode: re-split the merged output at the recorded mate boundary
    # into _1/_2 files and compress those
    if paired_split is not None and not cfg.original:
        with log.step("paired re-split"):
            half1, half2 = _split_pair(fq, paired_split)
            # the bytes of the line-list join these halves have always had:
            # "\n" for an empty half, one final newline after the second
            with open(base + "_1.fq", "wb") as f:
                f.write(half1 if len(half1) else b"\n")
            with open(base + "_2.fq", "wb") as f:
                f.write(bytes(half2).rstrip(b"\n") + b"\n")

    streams = []
    if cfg.mode == 1:
        streams = [base + ".fq"] if paired_split is None else [base + "_1.fq", base + "_2.fq"]
    elif cfg.mode in (2, 3):
        with log.step("step4: stream split"):
            if fq is None:
                with open(base + ".fq", "rb") as f:
                    fq = f.read()
            buf, starts = _line_starts(fq)
            for ext, first in ((".fq.dna", 1), (".fq.qs", 3)):
                with open(base + ext, "wb") as f:
                    f.write(_every_fourth(buf, starts, first))
        streams = [base + ".fq.dna", base + ".fq.qs"]
        if cfg.mode == 3:
            streams.append(base + ".h")

    # ---- step 5 ----
    outputs: Dict[str, List[str]] = {}
    if cfg.mode != 0 and streams:
        outputs = step5_compress(streams, cfg.codecs, log)

    # ---- report ----
    insize = sum(os.path.getsize(p) for p in inputs)
    report = {"original_mb": insize / 2**20}
    for codec, files in outputs.items():
        outsize = sum(os.path.getsize(f) for f in files)
        report[f"{codec}_mb"] = outsize / 2**20
        report[f"{codec}_ratio"] = outsize / insize
        log.info(f"{codec}: {outsize/2**20:.2f} MB, ratio {outsize/insize:.3f}")

    if paired_split is not None:
        with open(_meta_path(base + ".paired"), "w") as f:
            json.dump({"reads_file1": paired_split}, f)

    report["phases"] = list(log.phases)
    log.close()
    return PipelineResult(streams=streams, outputs=outputs, stats=stats, report=report)


def _concat(batches: List[ReadBatch]) -> ReadBatch:
    """The batches' reads one after another, each padded to the widest:
    paired mode's file-1 then file-2 reads, and block mode's blocks."""
    width = max(b.max_len for b in batches)
    seqs = np.concatenate([np.pad(b.seqs, ((0, 0), (0, width - b.max_len))) for b in batches])
    quals = np.concatenate([np.pad(b.quals, ((0, 0), (0, width - b.max_len))) for b in batches])
    lengths = np.concatenate([b.lengths for b in batches])
    headers = None
    if all(b.headers is not None for b in batches):
        headers = [h for b in batches for h in b.headers]
    return ReadBatch(seqs=seqs, quals=quals, lengths=lengths, headers=headers)


def _block_permutation(n: int, blocks: int, paired_split: Optional[int]):
    """Read order for block mode.  Unpaired: contiguous ~equal blocks.
    Paired: each block holds its share of file-1 reads followed by the
    matching file-2 reads, so mates land in the same block's EBWT.  Returns
    (perm, block index bounds in permuted order)."""
    if paired_split is None:
        size = (n + blocks - 1) // blocks
        bounds = [(b * size, min((b + 1) * size, n)) for b in range(blocks)]
        return np.arange(n), bounds
    n1 = paired_split
    n2 = n - n1
    s1 = (n1 + blocks - 1) // blocks
    s2 = (n2 + blocks - 1) // blocks
    idx, bounds, off = [], [], 0
    for b in range(blocks):
        lo1, hi1 = b * s1, min((b + 1) * s1, n1)
        lo2, hi2 = b * s2, min((b + 1) * s2, n2)
        idx.append(np.arange(lo1, hi1))
        idx.append(n1 + np.arange(lo2, hi2))
        take = (hi1 - lo1) + (hi2 - lo2)
        bounds.append((off, off + take))
        off += take
    return np.concatenate(idx), bounds


def _ranks_available(device: torch.device) -> int:
    """How many ranks block mode may run at once: one card each on CUDA,
    one core each for gloo ranks on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def _blockwise_step1_3(batch, base, cfg, blocks, log, device, paired_split=None) -> ReadBatch:
    """Block mode: an independent EBWT per ~equal read block.  With equal
    blocks and a rank for each, every block runs at once on its own rank
    (parallel/block.py, the JAX package's mesh route); otherwise the blocks
    run one after another on the device.  Both routes give the same bytes.
    Returns the blocks' reads back in input order: file-1 reads then file-2
    reads, which the paired re-split cuts at paired_split.

    In the sequential route every block shorter than the largest is filled
    up with dummy 1-base 'A' reads of quality '!', and those are real reads
    in that block's EBWT: the JAX package's sequential block route adds
    them, so its output depends on them.  They are a semantic of that CLI,
    kept for byte equality, not a compile-shape workaround."""
    n = batch.num_reads
    perm, bounds = _block_permutation(n, blocks, paired_split)
    work = ReadBatch(seqs=batch.seqs[perm], quals=batch.quals[perm], lengths=batch.lengths[perm])

    if len({hi - lo for lo, hi in bounds}) == 1 and _ranks_available(device) >= blocks:
        from bfqzip_tpu_torch.parallel import block_smooth_fastq

        with log.step(f"blocks 1-{blocks}: rank-parallel EBWT+smooth+invert"):
            merged, _ = block_smooth_fastq(work, cfg.smooth, blocks, device=device,
                                           work_dir=os.path.dirname(os.path.abspath(base)))
    else:
        size = max(hi - lo for lo, hi in bounds)
        parts = []
        for b, (lo, hi) in enumerate(bounds):
            take = hi - lo
            seqs_b = np.zeros((size, batch.max_len), np.uint8)
            quals_b = np.zeros((size, batch.max_len), np.uint8)
            lens_b = np.ones(size, np.int32)
            seqs_b[:take] = work.seqs[lo:hi]
            quals_b[:take] = work.quals[lo:hi]
            lens_b[:take] = work.lengths[lo:hi]
            if take < size:
                seqs_b[take:, 0] = alphabet.A
                quals_b[take:, 0] = ord("!")
            sub = ReadBatch(seqs=seqs_b, quals=quals_b, lengths=lens_b)
            with log.step(f"block {b+1}/{blocks}: EBWT+smooth+invert ({take} reads)"):
                out, _ = smooth_fastq(sub, cfg.smooth, device=device)
            parts.append(ReadBatch(seqs=out.seqs[:take], quals=out.quals[:take],
                                   lengths=out.lengths[:take]))
        merged = _concat(parts)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    return ReadBatch(seqs=merged.seqs[inv], quals=merged.quals[inv], lengths=merged.lengths[inv])
