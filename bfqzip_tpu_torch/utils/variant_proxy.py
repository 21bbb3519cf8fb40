"""Tool-free variant-preservation harness.

Port of bfqzip_tpu/utils/variant_proxy.py: the simulator, the caller and
the scoring are NumPy copies (the same seed gives the same reads in both
packages); the pileups count on the device, and the smoothing runs through
the port's engine.smooth_fastq, on the card unless `device="cpu"` (or
`--cpu`) asks for the CPU:

    python -m bfqzip_tpu_torch.utils.variant_proxy [--cpu] [--reads N ...]

The reference's de-facto acceptance test is a GATK SNP-calling pipeline plus
`rtg vcfeval` agreement between original and smoothed reads
(reference variant_calling/pipeline_SNPsCall.sh:28-50, README.md:86-100).
bwa/GATK/rtg are unavailable in this environment, but the reads here are
*simulated* from a known genome, so alignments are known exactly and a naive
pileup caller measures the same thing those tools would: does smoothing
preserve the evidence for true variants while removing sequencing noise?

The harness plants heterozygous SNPs in a diploid genome, samples reads with
known (start, strand, haplotype), runs the naive pileup caller on the original
and on the smoothed reads, and reports precision/recall against the planted
truth set — the in-repo stand-in for rtg vcfeval's TP/FP/FN accounting.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bfqzip_tpu_torch.engine import resolve_device, smooth_fastq
from bfqzip_tpu_torch.io.fastq import ReadBatch

# genome bases 0..3 = ACGT; alphabet codes (alphabet.py): A=1 C=2 G=3 N=4 T=5
_BASE2CODE = np.array([1, 2, 3, 5], np.uint8)
_CODE2BASE = np.full(6, -1, np.int8)
for _b, _c in enumerate(_BASE2CODE):
    _CODE2BASE[_c] = _b
_COMP = np.array([3, 2, 1, 0], np.int8)  # A<->T, C<->G


@dataclasses.dataclass
class DiploidSim:
    """A simulated diploid sequencing run with known truth."""

    genome: np.ndarray  # [G] i8 reference haplotype (bases 0..3)
    snp_pos: np.ndarray  # [S] i64 planted heterozygous SNP positions
    snp_alt: np.ndarray  # [S] i8 alternate allele at each SNP (on haplotype 1)
    batch: ReadBatch  # the reads (codes + qualities)
    starts: np.ndarray  # [N] i64 alignment start of each read on the genome
    strands: np.ndarray  # [N] bool True = reverse-complement
    haps: np.ndarray  # [N] i8 haplotype each read was sampled from


def simulate_diploid(
    n_reads: int,
    read_len: int,
    genome_len: int,
    n_snps: int,
    seed: int = 0,
    err: float = 0.005,
    n_rate: float = 0.001,
) -> DiploidSim:
    """Sample reads from a diploid genome with planted heterozygous SNPs.

    Haplotype 0 is the reference; haplotype 1 differs at `n_snps` positions
    (min spacing 2*read_len so SNP clusters don't interact).  Reads carry
    position-dependent qualities and substitution errors biased to low-quality
    positions — the same noise model as tools/make_realistic.py, so the
    smoother sees realistic clusters.
    """
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.int8)

    # planted het SNPs, spaced >= 2*read_len apart
    spacing = 2 * read_len
    max_snps = (genome_len - 2 * read_len) // spacing
    if n_snps > max_snps:
        raise ValueError(f"n_snps {n_snps} too dense for genome {genome_len}")
    slots = rng.choice(max_snps, size=n_snps, replace=False)
    snp_pos = np.sort(read_len + slots * spacing + rng.integers(0, spacing // 2, n_snps))
    shift = rng.integers(1, 4, n_snps).astype(np.int8)
    snp_alt = ((genome[snp_pos] + shift) % 4).astype(np.int8)
    hap1 = genome.copy()
    hap1[snp_pos] = snp_alt

    starts = rng.integers(0, genome_len - read_len, n_reads)
    haps = rng.integers(0, 2, n_reads).astype(np.int8)
    offs = np.arange(read_len)
    pos = starts[:, None] + offs[None, :]
    reads = np.where(haps[:, None] == 0, genome[pos], hap1[pos])

    strands = rng.random(n_reads) < 0.5
    reads[strands] = _COMP[reads[strands][:, ::-1]]

    # quality declines toward the 3' end (Illumina-like), leaving real mass
    # below the smoother's Q20 trust threshold so untrusted errors exist
    pos_mean = 38.0 - 18.0 * (offs / read_len) ** 1.5
    qual = np.clip(rng.normal(pos_mean[None, :], 4.0, (n_reads, read_len)), 2, 40).astype(np.int8)
    perr = err * 10 ** ((20 - qual) / 30.0)
    is_err = rng.random((n_reads, read_len)) < perr
    eshift = rng.integers(1, 4, (n_reads, read_len)).astype(np.int8)
    reads = np.where(is_err, (reads + eshift) % 4, reads)

    # rare no-calls at quality 2 (the bulk of real correction targets)
    is_n = rng.random((n_reads, read_len)) < n_rate
    qual = np.where(is_n, 2, qual).astype(np.int8)

    seqs = _BASE2CODE[reads]
    seqs = np.where(is_n, 4, seqs).astype(np.uint8)  # alphabet code 4 = N
    batch = ReadBatch(
        seqs=seqs,
        quals=(qual + 33).astype(np.uint8),
        lengths=np.full(n_reads, read_len, np.int32),
    )
    return DiploidSim(
        genome=genome, snp_pos=snp_pos, snp_alt=snp_alt, batch=batch,
        starts=starts.astype(np.int64), strands=strands, haps=haps,
    )


def pileup_counts(
    batch: ReadBatch, starts: np.ndarray, strands: np.ndarray, genome_len: int, device="cuda"
) -> np.ndarray:
    """[G, 4] base counts per genome position from known alignments.

    Reverse-strand reads are mapped back: read position k covers genome
    position start + L-1-k with the complemented base.  N calls are skipped.
    Counted on `device` by one bincount of gpos * 4 + base over the valid
    lanes (integer counts: exact, whatever the order of the atomics).
    """
    dev = resolve_device(device)
    seqs = torch.as_tensor(np.ascontiguousarray(batch.seqs, np.uint8)).to(dev)
    lens = torch.as_tensor(np.asarray(batch.lengths, np.int64)).to(dev)[:, None]
    start = torch.as_tensor(np.asarray(starts, np.int64)).to(dev)[:, None]
    rev = torch.as_tensor(np.asarray(strands, bool)).to(dev)[:, None]
    offs = torch.arange(seqs.shape[1], device=dev)[None, :]
    gpos = torch.where(rev, start + lens - 1 - offs, start + offs)
    bases = torch.as_tensor(_CODE2BASE).to(dev)[seqs.long()]
    comp = torch.where(bases >= 0, torch.as_tensor(_COMP).to(dev)[bases.clamp(0, 3).long()], -1)
    bases = torch.where(rev, comp, bases)
    valid = (bases >= 0) & (offs < lens)
    counts = torch.bincount(gpos[valid] * 4 + bases[valid], minlength=4 * genome_len)
    return counts.view(genome_len, 4).cpu().numpy()


def call_snps(
    counts: np.ndarray,
    genome: np.ndarray,
    min_depth: int = 8,
    min_alt: int = 4,
    alt_frac: float = 0.25,
) -> dict[int, int]:
    """Naive pileup caller: {position: alt allele} for non-reference calls.

    A position is called when the most frequent non-reference allele has
    >= min_alt supporting reads and >= alt_frac of a >= min_depth pileup —
    the evidence thresholds a real caller's genotype likelihoods encode.
    """
    glen = counts.shape[0]
    depth = counts.sum(axis=1)
    ref = genome.astype(np.int64)
    nonref = counts.copy()
    nonref[np.arange(glen), ref] = 0
    alt = nonref.argmax(axis=1)
    alt_n = nonref[np.arange(glen), alt]
    called = (depth >= min_depth) & (alt_n >= min_alt) & (alt_n >= alt_frac * depth)
    return {int(p): int(alt[p]) for p in np.flatnonzero(called)}


def evaluate(calls: dict[int, int], snp_pos: np.ndarray, snp_alt: np.ndarray) -> dict:
    """Precision/recall of calls vs the planted truth (allele must match)."""
    truth = {int(p): int(a) for p, a in zip(snp_pos, snp_alt)}
    tp = sum(1 for p, a in calls.items() if truth.get(p) == a)
    fp = len(calls) - tp
    fn = len(truth) - tp
    return {
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "precision": tp / max(tp + fp, 1),
        "recall": tp / max(tp + fn, 1),
    }


def run_proxy(
    n_reads: int = 40_000,
    read_len: int = 101,
    genome_len: int = 120_000,
    n_snps: int = 60,
    seed: int = 0,
    cfg=None,
    device="cuda",
) -> dict:
    """Simulate -> call original -> smooth -> call smoothed -> metrics,
    with the pileups and the smoothing on `device`."""
    sim = simulate_diploid(n_reads, read_len, genome_len, n_snps, seed)
    counts_o = pileup_counts(sim.batch, sim.starts, sim.strands, genome_len, device)
    calls_o = call_snps(counts_o, sim.genome)

    smoothed, stats = smooth_fastq(sim.batch, cfg, device=device)
    counts_s = pileup_counts(smoothed, sim.starts, sim.strands, genome_len, device)
    calls_s = call_snps(counts_s, sim.genome)

    # per-SNP alt-allele support before/after (evidence preservation)
    alt_o = counts_o[sim.snp_pos, sim.snp_alt]
    alt_s = counts_s[sim.snp_pos, sim.snp_alt]

    return {
        "original": evaluate(calls_o, sim.snp_pos, sim.snp_alt),
        "smoothed": evaluate(calls_s, sim.snp_pos, sim.snp_alt),
        "alt_support_orig": alt_o,
        "alt_support_smooth": alt_s,
        "bases_modified": stats.get("modified", 0),
        "n_snps": n_snps,
    }


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reads", type=int, default=40_000)
    ap.add_argument("--len", dest="read_len", type=int, default=101)
    ap.add_argument("--genome", type=int, default=120_000)
    ap.add_argument("--snps", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    res = run_proxy(args.reads, args.read_len, args.genome, args.snps, args.seed,
                    device="cpu" if args.cpu else "cuda")
    out = {
        "original": res["original"],
        "smoothed": res["smoothed"],
        "bases_modified": int(res["bases_modified"]),
        "alt_support_drop_max": int(
            (res["alt_support_orig"] - res["alt_support_smooth"]).max(initial=0)
        ),
    }
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
