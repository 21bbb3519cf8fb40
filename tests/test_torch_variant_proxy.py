"""The port's variant-preservation proxy (bfqzip_tpu_torch.utils.variant_proxy)
on the CPU: run_proxy equals the JAX package's field for field, and the three
cases of tests/test_variant_proxy.py hold for the port."""

import numpy as np
import pytest

from bfqzip_tpu.utils import variant_proxy as jax_variant_proxy
from bfqzip_tpu_torch.engine import smooth_fastq
from bfqzip_tpu_torch.utils.variant_proxy import (
    call_snps,
    evaluate,
    pileup_counts,
    run_proxy,
    simulate_diploid,
)
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

ARGS = dict(n_reads=20_000, read_len=101, genome_len=60_000, n_snps=25, seed=0)


@pytest.fixture(scope="module")
def jax_result():
    return jax_variant_proxy.run_proxy(**ARGS)


@pytest.fixture(scope="module")
def port_result():
    return run_proxy(**ARGS, device="cpu")


def test_run_proxy_equals_jax(port_result, jax_result):
    assert set(port_result) == set(jax_result)
    for key, want in jax_result.items():
        got = port_result[key]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), key
        else:
            assert got == want, key


def test_pileup_caller_finds_planted_snps():
    """Sanity: on ORIGINAL reads the caller recovers essentially all SNPs."""
    sim = simulate_diploid(20_000, 101, 60_000, 25, seed=1)
    counts = pileup_counts(sim.batch, sim.starts, sim.strands, 60_000, device="cpu")
    res = evaluate(call_snps(counts, sim.genome), sim.snp_pos, sim.snp_alt)
    assert res["recall"] >= 0.95, res
    assert res["precision"] >= 0.95, res


def test_smoothing_preserves_variant_evidence(port_result):
    """Smoothed recall and precision do not degrade, and no planted SNP
    loses more than 10% of its alt-allele support."""
    res = port_result
    o, s = res["original"], res["smoothed"]
    assert res["bases_modified"] > 0, "smoother did no work - test under-powered"
    assert s["recall"] >= o["recall"], (o, s)
    assert s["precision"] >= o["precision"], (o, s)
    drop = res["alt_support_orig"] - res["alt_support_smooth"]
    frac = drop / np.maximum(res["alt_support_orig"], 1)
    assert frac.max(initial=0.0) <= 0.1, f"alt-allele support dropped >10% at {int(frac.argmax())}"


def test_smoothing_removes_noise():
    """Base correction reduces non-ref noise at NON-SNP positions."""
    glen = 60_000
    sim = simulate_diploid(20_000, 101, glen, 25, seed=2)
    counts_o = pileup_counts(sim.batch, sim.starts, sim.strands, glen, device="cpu")
    smoothed, _ = smooth_fastq(sim.batch, device="cpu")
    counts_s = pileup_counts(smoothed, sim.starts, sim.strands, glen, device="cpu")
    ref = sim.genome.astype(np.int64)
    idx = np.arange(glen)
    noise_o = counts_o.sum(1) - counts_o[idx, ref]
    noise_s = counts_s.sum(1) - counts_s[idx, ref]
    mask = np.ones(glen, bool)
    mask[sim.snp_pos] = False
    assert noise_s[mask].sum() < noise_o[mask].sum(), (noise_o[mask].sum(), noise_s[mask].sum())


def test_main_runs_on_the_cpu_only_when_asked(monkeypatch, capsys):
    import json

    import torch

    from bfqzip_tpu_torch.utils import variant_proxy

    argv = ["--reads", "3000", "--genome", "12000", "--snps", "5"]
    assert variant_proxy.main(argv + ["--cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"original", "smoothed", "bases_modified", "alt_support_drop_max"}
    assert out["original"]["tp"] + out["original"]["fn"] == 5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        variant_proxy.main(argv)
