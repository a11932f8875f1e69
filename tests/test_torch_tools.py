"""helen_tpu's tool tests (tests/test_tools.py) run through the port's
copies: the dev/analysis tools, hyperband's schedule and the marginpolish
wrapper; then ``assess`` (JSON, with and without a BED) against helen_tpu's
on the same FASTAs, and ``download_models`` over ``file://``."""
import io
import os
import sys

import numpy as np
import pytest

from helen_tpu_torch.io.synthetic import random_sequence, write_image_file
from helen_tpu_torch.tools import assess_summary, compare_images, image_viewer, loss_curves
from helen_tpu_torch.tools import pairwise_alignment, quast_sv_extractor, vcf_remove_phase


@pytest.fixture(scope="module")
def image_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    path = str(d / "img.h5")
    write_image_file(path, {"c": random_sequence(3000, seed=4)}, region_cols=800)
    return path


def test_image_viewer(image_file, capsys):
    assert image_viewer.main(["-i", image_file, "--labels", "--end", "5"]) == 0
    out = capsys.readouterr().out
    assert "true=" in out and "# c:" in out


def test_compare_images_identical(image_file, capsys):
    assert compare_images.main(["-a", image_file, "-b", image_file]) == 0
    assert "feature mismatches: 0" in capsys.readouterr().out


def test_compare_images_different(tmp_path, capsys):
    a = str(tmp_path / "a.h5")
    b = str(tmp_path / "b.h5")
    write_image_file(a, {"c": random_sequence(1000, seed=1)}, region_cols=500)
    write_image_file(b, {"c": random_sequence(1000, seed=2)}, region_cols=500)
    assert compare_images.main(["-a", a, "-b", b]) == 1


def test_loss_curves(tmp_path, capsys):
    train = tmp_path / "train_loss.csv"
    train.write_text("1,1,0.5\n1,2,0.4\n2,1,0.3\n")
    test = tmp_path / "test_loss.csv"
    test.write_text("1,0.45,80.0\n2,0.30,92.0\n")
    assert loss_curves.main(["--train_csv", str(train), "--test_csv", str(test)]) == 0
    out = capsys.readouterr().out
    assert "best epoch: 2" in out


def test_quast_sv_extractor(tmp_path, capsys):
    quast = tmp_path / "mis.info"
    quast.write_text(
        "relocation between chr1:100-5000 and chr1:9000-12000\n"
        "inversion at chr2:50-800\n"
    )
    bed = tmp_path / "svs.bed"
    bed.write_text("chr1\t4800\t5200\tDEL\n")
    assert quast_sv_extractor.main(["-q", str(quast), "-s", str(bed), "--slop", "100"]) == 0
    out = capsys.readouterr().out
    assert "misassemblies:        3" in out  # 3 coordinate spans found
    assert "explained by SVs:     1" in out


def test_assess_summary(tmp_path, capsys):
    # pomoxis layout: a Percentage-Errors section (values are PERCENT) and
    # a Q-Scores section that REUSES the metric names
    s = tmp_path / "summary.txt"
    s.write_text(
        "#  Percentage Errors\n"
        "  name    mean\n"
        "  err_ont 0.100%\n  err_bal 0.120%\n  iden 0.999\n"
        "#  Q Scores\n"
        "  name    mean\n"
        "  err_ont 30.00\n  err_bal 29.21\n"
    )
    stats = assess_summary.parse_summary(str(s))
    assert stats["err_ont"] == 0.1 and stats["Qscore"] == 30.0
    assert assess_summary.main([str(s)]) == 0
    out = capsys.readouterr().out
    assert "30" in out

    # no Q-Scores section: Qscore derived from the PERCENTAGE err_ont
    s2 = tmp_path / "summary2.txt"
    s2.write_text("name    err_ont 0.1  err_bal 0.12  iden 0.999\n")
    stats2 = assess_summary.parse_summary(str(s2))
    assert abs(stats2["Qscore"] - 30.0) < 1e-6  # -10*log10(0.1/100)


def test_vcf_remove_phase(tmp_path):
    vcf = tmp_path / "in.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
        "chr1\t10\t.\tA\tT\t30\tPASS\t.\tGT:PS:DP\t1|0:12345:30\n"
        "chr1\t20\t.\tC\tG\t30\tPASS\t.\tGT:DP\t0/1:22\n"
        "chr1\t30\t.\tG\tC\t30\tPASS\t.\tPS:GT\tp1:1|0\n"
    )
    out = tmp_path / "out.vcf"
    assert vcf_remove_phase.main(["-i", str(vcf), "-o", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert lines[2].endswith("GT:DP\t0/1:30")  # phased 1|0 -> 0/1, PS dropped
    assert lines[3].endswith("GT:DP\t0/1:22")  # untouched
    assert lines[4].endswith("\tGT\t0/1")  # PS BEFORE GT: still unphased


def test_pairwise_alignment(capsys):
    a = random_sequence(120, seed=6)
    b = a[40:100]
    assert pairwise_alignment.main([a, b]) == 0
    out = capsys.readouterr().out
    assert "seed k-mer match: (40, 0)" in out
    assert "score=240" in out  # 60 matches x 4


def test_marginpolish_wrapper_missing_binary(monkeypatch, capsys):
    from helen_tpu_torch import marginpolish

    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("HELEN_TPU_MARGINPOLISH", raising=False)
    assert marginpolish.main(["--help"]) == 127
    assert "marginPolish binary not found" in capsys.readouterr().err


def test_marginpolish_wrapper_passthrough(tmp_path, monkeypatch, capsys):
    from helen_tpu_torch import marginpolish

    fake = tmp_path / "marginPolish"
    fake.write_text("#!/bin/sh\necho polished $@\nexit 0\n")
    fake.chmod(0o755)
    monkeypatch.setenv("HELEN_TPU_MARGINPOLISH", str(fake))
    assert marginpolish.main(["reads.bam", "draft.fa", "params.json"]) == 0


def test_marginpolish_wrapper_bundled_binary(tmp_path, monkeypatch):
    """A binary at helen_tpu_torch/bin/marginPolish (the Docker image's pinned
    v1.3.0 build location) is found without env or PATH setup."""
    import helen_tpu_torch.marginpolish as mp

    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("HELEN_TPU_MARGINPOLISH", raising=False)
    fake_pkg = tmp_path / "pkg"
    (fake_pkg / "bin").mkdir(parents=True)
    fake = fake_pkg / "bin" / "marginPolish"
    fake.write_text("#!/bin/sh\nexit 0\n")
    fake.chmod(0o755)
    monkeypatch.setattr(mp.os.path, "dirname", lambda _p: str(fake_pkg))
    assert mp.find_marginpolish() == str(fake)


def test_vendored_masked_regions_bed(tmp_path):
    """The vendored GRCh38 assessment BED (masked_regions/) parses and
    drives bed_mask end to end."""
    from helen_tpu_torch.tools import bed_mask
    from helen_tpu_torch.tools.quast_sv_extractor import read_bed

    bed = os.path.join(os.path.dirname(__file__), "..", "masked_regions",
                       "GRCh38_masked_regions.bed")
    intervals = read_bed(bed)
    assert sum(len(v) for v in intervals.values()) == 5204
    assert "chr1" in intervals and "chrX" in intervals
    # apply the real chr1 intervals to a toy chr1 FASTA
    fa = tmp_path / "asm.fa"
    fa.write_text(">chr1\n" + "A" * 300000 + "\n")
    out = tmp_path / "masked.fa"
    n = bed_mask.mask_fasta(str(fa), bed, str(out))
    # first chr1 interval is 0-217666 plus 247666-300000 of the second
    assert n == 217666 + (300000 - 247666)
    seq = out.read_text().splitlines()[1]
    assert seq[:217666] == "N" * 217666 and seq[217667] == "A"


def test_hyperband_schedule():
    from helen_tpu_torch.train.hyperband import Hyperband

    calls = []

    def run_trial(cfg, epochs, state):
        calls.append((cfg["learning_rate"], epochs, state))
        # pretend lower lr is better
        return cfg["learning_rate"], f"state_{len(calls)}"

    hb = Hyperband(run_trial, max_epochs=9, eta=3, seed=1)
    best = hb.run()
    assert best.loss == min(c[0] for c in calls)
    # survivors must have been resumed with their carried state
    assert any(c[2] is not None for c in calls)
    # rung budgets are DELTAS on top of the resumed checkpoint (1, +2, +6 for
    # the s=2 bracket) — resumed trials never retrain the full rung total
    assert all(c[1] <= 6 for c in calls if c[2] is not None)
    assert max(c[1] for c in calls) == 9  # the s=0 bracket trains 9 in one go


def test_bed_mask(tmp_path, capsys):
    from helen_tpu_torch.tools import bed_mask

    fa = tmp_path / "in.fa"
    fa.write_text(">c1\nACGTACGTAC\n>c2\nGGGG\n")
    bed = tmp_path / "mask.bed"
    bed.write_text("c1\t2\t5\nc1\t8\t100\n")
    out = tmp_path / "out.fa"
    assert bed_mask.main(["-i", str(fa), "-b", str(bed), "-o", str(out)]) == 0
    from helen_tpu_torch.io.fasta import read_fasta

    seqs = dict(read_fasta(str(out)))
    assert seqs["c1"] == "ACNNNCGTNN"
    assert seqs["c2"] == "GGGG"


def test_assess_polish(tmp_path, capsys):
    """Native banded edit distance drives the truth-vs-polished report:
    exact contigs Q-cap, a contig with known edits counts them exactly,
    missing contigs exit nonzero."""
    from helen_tpu_torch.tools import assess_polish

    truth_seq = random_sequence(20000, seed=11)
    # 3 known edits: 1 substitution, 1 insertion, 1 deletion
    mutated = list(truth_seq)
    mutated[500] = "A" if mutated[500] != "A" else "C"
    mutated.insert(10000, "G")
    del mutated[15000]
    mutated = "".join(mutated)
    assert assess_polish.edit_distance(truth_seq, mutated) == 3
    assert assess_polish.edit_distance(truth_seq, truth_seq) == 0
    # unalignable: completely different sequence within a small band
    assert assess_polish.edit_distance("A" * 3000, "T" * 3000,
                                       max_band=64) is None
    # the band sequence clamps to END at max_band (r4 review): a distance
    # in (last_power_of_2, max_band] and a length gap with 2*gap > max_band
    # must both still be found
    assert assess_polish.edit_distance("A" * 1000, "A" * 1100,
                                       max_band=150) == 100
    # case-insensitive (r4 advisor): soft-masked truth (lowercase repeats,
    # GRCh38-style) vs uppercase polished output must not count case
    # differences as edits
    soft_masked = truth_seq[:5000].lower() + truth_seq[5000:]
    assert assess_polish.edit_distance(soft_masked, truth_seq) == 0
    assert assess_polish.edit_distance(soft_masked, mutated) == 3

    truth_fa = tmp_path / "truth.fa"
    truth_fa.write_text(f">c1\n{truth_seq}\n>c2\n{truth_seq}\n>gone\nACGT\n")
    pol_fa = tmp_path / "polished.fa"
    pol_fa.write_text(f">c1\n{truth_seq}\n>c2\n{mutated}\n>novel\nACGT\n")
    rc = assess_polish.main(["-t", str(truth_fa), "-p", str(pol_fa)])
    out = capsys.readouterr().out
    assert rc == 1  # 'gone' missing
    assert "c1\t20000\t0 edits" in out
    assert "c2\t20000\t3 edits" in out
    assert "gone\tMISSING" in out
    assert "novel\tEXTRA" in out
    assert "TOTAL\t40000\t3 edits" in out


def test_anchored_bed_mask_invariant_under_upstream_indels(tmp_path):
    """SSW-anchored masking (r5, VERDICT r4 item 7): the masked-assessment
    edit count must be IDENTICAL with and without indels upstream of the
    masked interval — coordinate masking drifts, anchored masking tracks
    the sequence."""
    from helen_tpu_torch.io.fasta import read_fasta
    from helen_tpu_torch.tools import assess_polish, bed_mask

    truth_seq = random_sequence(12000, seed=42)
    bed = tmp_path / "mask.bed"
    bed.write_text("ctg\t5000\t6000\n")
    truth_fa = tmp_path / "truth.fa"
    truth_fa.write_text(f">ctg\n{truth_seq}\n")

    def polish_variant(upstream_indels: bool) -> str:
        s = list(truth_seq)
        # 3 real edits INSIDE the masked interval (must vanish from the
        # masked count) and 2 real edits OUTSIDE it (must always count)
        for pos in (5200, 5500, 5800):
            s[pos] = "A" if s[pos] != "A" else "C"
        s[2000] = "A" if s[2000] != "A" else "C"
        s[8000] = "A" if s[8000] != "A" else "C"
        if upstream_indels:
            # net +37 bases upstream of the interval: shifts every
            # downstream coordinate, the exact failure mode of
            # coordinate masking
            s[3000:3000] = list("G" * 40)
            del s[1000:1003]
        return "".join(s)

    counts = {}
    for tag in ("plain", "indel"):
        pol_fa = tmp_path / f"pol_{tag}.fa"
        pol_fa.write_text(f">ctg\n{polish_variant(tag == 'indel')}\n")
        pol_masked = tmp_path / f"pol_{tag}_masked.fa"
        truth_masked = tmp_path / f"truth_{tag}_masked.fa"
        stats = bed_mask.anchored_mask_fasta(
            str(pol_fa), str(truth_fa), str(bed), str(pol_masked),
            out_truth=str(truth_masked))
        assert stats["anchored"] == 1 and stats["fallback"] == 0
        report = assess_polish.assess(
            dict(read_fasta(str(truth_masked))),
            dict(read_fasta(str(pol_masked))))
        counts[tag] = report["total_edits"]
    # 2 outside edits + the indels themselves count; the 3 masked-interval
    # edits never do, and the count is invariant modulo the indels' own
    # contribution (43 = 40 ins + 3 del)
    assert counts["plain"] == 2
    assert counts["indel"] == 2 + 43

    # CLI surface
    out = tmp_path / "cli_masked.fa"
    rc = bed_mask.main(["-i", str(tmp_path / "pol_indel.fa"), "-b", str(bed),
                        "-o", str(out), "--anchor_truth", str(truth_fa)])
    assert rc == 0
    masked_seq = dict(read_fasta(str(out)))["ctg"]
    # exactly the interval's span is masked, wherever it landed
    assert masked_seq.count("N") == 1000


def test_assess_with_bed_masking(tmp_path, capsys):
    """`helen_tpu assess --bed`: anchored masking runs inline and the
    masked report excludes interval-internal edits even with an upstream
    indel (the one-command form of the masked-regions protocol)."""
    from helen_tpu_torch.cli import main as cli_main
    from helen_tpu_torch.io.fasta import read_fasta  # noqa: F401 (parity w/ sibling test)

    truth_seq = random_sequence(10000, seed=77)
    s = list(truth_seq)
    s[4200] = "A" if s[4200] != "A" else "C"   # inside masked interval
    s[8000] = "A" if s[8000] != "A" else "C"   # outside: must count
    s[1000:1000] = list("TTTTT")                # +5 upstream indel
    pol = "".join(s)
    (tmp_path / "t.fa").write_text(f">c\n{truth_seq}\n")
    (tmp_path / "p.fa").write_text(f">c\n{pol}\n")
    (tmp_path / "m.bed").write_text("c\t4000\t4400\n")
    rc = cli_main(["assess", "-t", str(tmp_path / "t.fa"),
                   "-p", str(tmp_path / "p.fa"),
                   "-b", str(tmp_path / "m.bed")])
    out = capsys.readouterr().out
    assert rc == 0
    # 1 outside substitution + the 5-base insertion; the masked-interval
    # substitution is gone
    assert "TOTAL\t10000\t6 edits" in out


def test_anchored_bed_mask_edges_and_fallback(tmp_path):
    """Anchored masking edge cases: an interval starting at 0 (no left
    flank -> polished start), one ending at contig end (-> polished end),
    and an unanchorable flank (repeat sequence below the confidence gate)
    falling back to coordinate masking with the fallback counter."""
    from helen_tpu_torch.io.fasta import read_fasta
    from helen_tpu_torch.tools import bed_mask

    truth_seq = random_sequence(8000, seed=13)
    pol = truth_seq[:2000] + "AC" + truth_seq[2000:]  # +2 indel mid-contig
    (tmp_path / "t.fa").write_text(f">c\n{truth_seq}\n")
    (tmp_path / "p.fa").write_text(f">c\n{pol}\n")
    # start-anchored and end-anchored intervals
    (tmp_path / "edges.bed").write_text("c\t0\t500\nc\t7500\t8000\n")
    out = tmp_path / "edges_masked.fa"
    stats = bed_mask.anchored_mask_fasta(
        str(tmp_path / "p.fa"), str(tmp_path / "t.fa"),
        str(tmp_path / "edges.bed"), str(out))
    assert stats["fallback"] == 0
    seq = dict(read_fasta(str(out)))["c"]
    # [0,500) is upstream of the indel: masks polished [0,500); the end
    # interval shifts by +2
    assert seq[:500] == "N" * 500 and seq[500] != "N"
    assert seq[7501] != "N" and seq[7502:] == "N" * 500
    assert stats["masked_polished"] == 1000

    # unanchorable: a homopolymer truth whose flanks align anywhere gets
    # a low-confidence anchor or a wrong-order span -> coordinate fallback
    (tmp_path / "t2.fa").write_text(">r\n" + "A" * 4000 + "\n")
    (tmp_path / "p2.fa").write_text(">r\n" + "A" * 1000 + "C" * 3010 + "\n")
    (tmp_path / "rep.bed").write_text("r\t2000\t2100\n")
    out2 = tmp_path / "rep_masked.fa"
    stats2 = bed_mask.anchored_mask_fasta(
        str(tmp_path / "p2.fa"), str(tmp_path / "t2.fa"),
        str(tmp_path / "rep.bed"), str(out2))
    assert stats2["fallback"] == 1
    seq2 = dict(read_fasta(str(out2)))["r"]
    assert seq2[2000:2100] == "N" * 100  # coordinate-masked


def _assess_json(mod, argv, capsys):
    rc = mod.main(argv + ["--json"])
    out = capsys.readouterr().out
    return rc, [line for line in out.splitlines() if not line.startswith("#")]


@pytest.mark.parametrize("with_bed", [False, True])
def test_assess_json_matches_helen_tpu(tmp_path, capsys, with_bed):
    """The port's ``assess`` (tools.assess_polish on the port's native
    banded edit distance; with ``--bed`` the SSW-anchored masking) prints
    the same JSON report as helen_tpu's on the same truth and polished
    FASTAs."""
    from helen_tpu.tools import assess_polish as ref

    from helen_tpu_torch.tools import assess_polish

    truth_seq = random_sequence(12000, seed=21)
    mutated = list(truth_seq)
    for pos in (700, 4000, 9000):
        mutated[pos] = "A" if mutated[pos] != "A" else "C"
    mutated.insert(6000, "T")
    mutated = "".join(mutated)
    truth_fa = tmp_path / "truth.fa"
    truth_fa.write_text(f">c1\n{truth_seq}\n>c2\n{truth_seq[:5000]}\n")
    pol_fa = tmp_path / "polished.fa"
    pol_fa.write_text(f">c1\n{mutated}\n>c2\n{truth_seq[:5000]}\n")
    argv = ["-t", str(truth_fa), "-p", str(pol_fa)]
    if with_bed:
        bed = tmp_path / "mask.bed"
        bed.write_text("c1\t3900\t4100\nc1\t8900\t9100\n")
        argv += ["-b", str(bed)]
    got = _assess_json(assess_polish, argv, capsys)
    want = _assess_json(ref, argv, capsys)
    assert got == want
    assert got[0] == 0


def test_assess_cli_matches_helen_tpu(tmp_path, capsys):
    """``python -m helen_tpu_torch assess`` with ``--bed`` gives the report
    of helen_tpu's CLI."""
    from helen_tpu.cli import main as ref_main

    from helen_tpu_torch.cli import main

    seq = random_sequence(8000, seed=5)
    truth = tmp_path / "t.fa"
    truth.write_text(f">c\n{seq}\n")
    pol = tmp_path / "p.fa"
    pol.write_text(f">c\n{seq[:2000]}G{seq[2000:]}\n")
    bed = tmp_path / "m.bed"
    bed.write_text("c\t5000\t5200\n")
    argv = ["assess", "-t", str(truth), "-p", str(pol), "--json", "-b", str(bed)]
    assert main(argv) == 0
    got = capsys.readouterr().out
    assert ref_main(argv) == 0
    assert got == capsys.readouterr().out


def test_download_models_over_file_urls(tmp_path, monkeypatch):
    """``download_models`` reads a ``file://`` manifest (name,url rows;
    comments and bare-url rows), from ``--manifest_url`` or
    HELEN_TPU_MODEL_MANIFEST, keeps files already present, and the CLI
    writes the same files as helen_tpu's."""
    from helen_tpu_torch.cli import main
    from helen_tpu_torch.io.download import download_models

    src = tmp_path / "src"
    src.mkdir()
    (src / "a.pkl").write_bytes(b"model-a")
    (src / "b.npz").write_bytes(b"model-b" * 1000)
    manifest = tmp_path / "manifest.csv"
    manifest.write_text(f"# released models\nhelen_a,file://{src}/a.pkl\n"
                        f"file://{src}/b.npz\n")
    paths = download_models(str(tmp_path / "out"), f"file://{manifest}")
    assert [os.path.basename(p) for p in paths] == ["a.pkl", "b.npz"]
    assert (tmp_path / "out" / "b.npz").read_bytes() == b"model-b" * 1000
    (tmp_path / "out" / "a.pkl").write_bytes(b"kept")
    download_models(str(tmp_path / "out"), f"file://{manifest}")
    assert (tmp_path / "out" / "a.pkl").read_bytes() == b"kept"
    monkeypatch.setenv("HELEN_TPU_MODEL_MANIFEST", f"file://{manifest}")
    assert main(["download_models", "-o", str(tmp_path / "cli")]) == 0
    assert sorted(os.listdir(tmp_path / "cli")) == ["a.pkl", "b.npz"]
