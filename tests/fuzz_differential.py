"""Randomized differential CAMPAIGN vs the compiled reference C tools.

Not collected by pytest (no test_ prefix): this is the long-running
sweep the suite's per-tool differentials (test_differential_c.py) are a
subset of.  It compiles the reference binaries once, then drives every
tool over seeded random lanes — bigger, longer, uglier than the suite's
(mixed lengths, N-heavy, numeric qualities, -Q 64, long reads) — and
byte-compares stdout (plus the -v report for the report-bearing tools).
The collapser compares order-insensitively within equal-count groups
(the reference's tie order is libstdc++ hash-iteration order, SURVEY
§3.4).

    python tests/fuzz_differential.py [--seeds N] [--reads N]

Exit code 0 = every comparison identical; any mismatch prints the
repro (tool, argv, seed) and exits 1.  Runs on whichever backend JAX
picks (JAX_PLATFORMS=cpu for the CPU).
"""

import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
R = "/root/reference/src"
BIN = os.path.join(REPO, "bin")
REFBIN = os.environ.get("FASTX_FUZZ_REFBIN", "/tmp/fastx_fuzz_refbin")


def build_refbins():
    os.makedirs(REFBIN, exist_ok=True)
    stamp = os.path.join(REFBIN, ".built")
    if os.path.exists(stamp):
        return
    open(os.path.join(REFBIN, "config.h"), "w").write(
        '#define PACKAGE_STRING "FASTX Toolkit 0.0.14"\n'
    )
    objs = []
    for src in ("fastx.c", "fastx_args.c", "chomp.c"):
        o = os.path.join(REFBIN, src + ".o")
        subprocess.run(
            ["gcc", "-O3", "-I", REFBIN, "-I", f"{R}/libfastx", "-c",
             f"{R}/libfastx/{src}", "-o", o],
            check=True, capture_output=True,
        )
        objs.append(o)
    c_tools = ("fastq_to_fasta", "fastq_quality_filter",
               "fastq_quality_trimmer", "fastq_masker", "fastx_trimmer",
               "fastx_artifacts_filter", "fastx_reverse_complement",
               "fastq_quality_converter", "fastx_renamer",
               "fasta_nucleotide_changer", "fastx_quality_stats")
    for t in c_tools:
        subprocess.run(
            ["gcc", "-O3", "-I", REFBIN, "-I", f"{R}/libfastx",
             f"{R}/{t}/{t}.c", *objs, "-o", os.path.join(REFBIN, t)],
            check=True, capture_output=True,
        )
    subprocess.run(
        ["g++", "-O3", "-I", REFBIN, "-I", f"{R}/libfastx",
         f"{R}/fastx_clipper/fastx_clipper.cpp",
         f"{R}/libfastx/sequence_alignment.cpp", *objs,
         "-o", os.path.join(REFBIN, "fastx_clipper")],
        check=True, capture_output=True,
    )
    subprocess.run(
        ["g++", "-O3", "-std=c++11", "-I", REFBIN, "-I", f"{R}/libfastx",
         f"{R}/fastx_collapser/fastx_collapser.cpp", *objs,
         "-o", os.path.join(REFBIN, "fastx_collapser")],
        check=True, capture_output=True,
    )
    open(stamp, "w").write("ok\n")


def synth_fastq(rng, n, lmin, lmax, *, pn=0.03, q_offset=33, numeric=False,
                adapter=None, p_ad=0.0):
    alpha = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for i in range(n):
        ln = int(rng.integers(lmin, lmax + 1))
        seq = rng.choice(alpha, size=ln)
        nmask = rng.random(ln) < pn
        seq[nmask] = ord("N")
        if adapter is not None and rng.random() < p_ad:
            pos = int(rng.integers(0, max(1, ln - 3)))
            ad = np.frombuffer(adapter, np.uint8)
            k = min(len(ad), ln - pos)
            seq[pos:pos + k] = ad[:k]
        q = rng.integers(-5, 41, size=ln)
        if numeric:
            ql = " ".join(str(int(v)) for v in q).encode()
        else:
            ql = (q + q_offset).astype(np.uint8).tobytes()
        out.append(b"@r%d\n%s\n+r%d\n%s\n"
                   % (i, seq.tobytes(), i, ql))
    return b"".join(out)


def synth_fasta(rng, n, lmin, lmax, *, pn=0.02, collapsed=False):
    alpha = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for i in range(n):
        ln = int(rng.integers(lmin, lmax + 1))
        seq = rng.choice(alpha, size=ln)
        seq[rng.random(ln) < pn] = ord("N")
        ident = (b">%d-%d" % (i, rng.integers(1, 9))
                 if collapsed else b">r%d" % i)
        out.append(ident + b"\n" + seq.tobytes() + b"\n")
    return b"".join(out)


def run_pair(tool, argv, data, *, with_report=False):
    """(c_out, c_rep, my_out, my_rep) for one invocation."""
    env = dict(os.environ)
    env["PATH"] = BIN + os.pathsep + env.get("PATH", "")
    args = list(argv) + (["-v"] if with_report else [])
    pc = subprocess.run([os.path.join(REFBIN, tool), *args], input=data,
                        capture_output=True, timeout=300)
    pm = subprocess.run([os.path.join(BIN, tool), *args], input=data,
                        capture_output=True, timeout=600, env=env)
    # the jax runtime banners ('WARNING:...', absl logs) and Python warnings ('/path/mod.py:12:
    # UserWarning: ...' plus its indented source-line continuation) are
    # not part of the tool's report surface
    kept, in_warning = [], False
    for ln in pm.stderr.split(b"\n"):
        if in_warning and ln[:1] in (b" ", b"\t"):
            continue
        in_warning = False
        if (ln.startswith(b"WARNING:") or ln.startswith(b"I0")
                or ln.startswith(b"E0") or ln.startswith(b"W0")):
            continue
        if re.match(rb"[^:\n]+\.py:\d+: \S*Warning", ln):
            in_warning = True
            continue
        kept.append(ln)
    pm.stderr = b"\n".join(kept)
    return pc, pm


def collapser_canon(out: bytes):
    """(count, sequence) multiset + the count sequence in rank order."""
    recs = []
    lines = out.split(b"\n")
    for i in range(0, len(lines) - 1, 2):
        if not lines[i]:
            continue
        cnt = int(lines[i].rsplit(b"-", 1)[1])
        recs.append((cnt, lines[i + 1]))
    return sorted(recs), [c for c, _ in recs]


def main():
    seeds = int(sys.argv[sys.argv.index("--seeds") + 1]) \
        if "--seeds" in sys.argv else 3
    n_reads = int(sys.argv[sys.argv.index("--reads") + 1]) \
        if "--reads" in sys.argv else 4000
    build_refbins()
    t0 = time.time()
    checks = fails = 0

    def check(tool, argv, data, *, with_report=False, canon=None):
        nonlocal checks, fails
        pc, pm = run_pair(tool, argv, data, with_report=with_report)
        checks += 1
        ok = pc.returncode == pm.returncode
        if ok:
            if canon is not None:
                ok = canon(pc.stdout) == canon(pm.stdout)
            else:
                ok = pc.stdout == pm.stdout
        if ok and with_report:
            ok = pc.stderr == pm.stderr
        if not ok:
            fails += 1
            print("MISMATCH %s %s (%d bytes in)"
                  % (tool, " ".join(argv), len(data)))
            for tag, a, b in (("stdout", pc.stdout, pm.stdout),
                              ("stderr", pc.stderr, pm.stderr)):
                if a != b:
                    i = next((k for k, (x, y) in
                              enumerate(zip(a, b)) if x != y),
                             min(len(a), len(b)))
                    print("  %s differs at byte %d: C=%r MY=%r"
                          % (tag, i, a[max(0, i - 30):i + 30],
                             b[max(0, i - 30):i + 30]))

    for s in range(seeds):
        rng = np.random.default_rng(1000 + s)
        fq = synth_fastq(rng, n_reads, 5, 120,
                         adapter=b"CTGTAGGCACCATCAAT", p_ad=0.3)
        fq64 = synth_fastq(rng, n_reads // 2, 10, 90, q_offset=64)
        fqnum = synth_fastq(rng, 500, 5, 60, numeric=True)
        fqlong = synth_fastq(rng, 200, 150, 1800, pn=0.01)
        fa = synth_fasta(rng, n_reads // 2, 5, 100)
        fac = synth_fasta(rng, n_reads // 2, 8, 40, collapsed=True)

        for q, p in ((10, 50), (20, 80), (30, 100)):
            check("fastq_quality_filter",
                  ["-Q", "33", "-q", str(q), "-p", str(p)], fq,
                  with_report=True)
        for t, l in ((10, 0), (20, 16), (35, 30)):  # noqa: E741
            argv = ["-Q", "33", "-t", str(t)] + \
                (["-l", str(l)] if l else [])
            check("fastq_quality_trimmer", argv, fq, with_report=True)
        for q, r in ((10, None), (25, "x")):
            argv = ["-Q", "33", "-q", str(q)] + \
                (["-r", r] if r else [])
            check("fastq_masker", argv, fq, with_report=True)
        check("fastx_trimmer", ["-Q", "33", "-f", "5", "-l", "36"], fq)
        check("fastx_trimmer", ["-Q", "33", "-t", "7", "-m", "16"], fq)
        check("fastq_to_fasta", ["-Q", "33"], fq, with_report=True)
        check("fastq_to_fasta", ["-Q", "33", "-n", "-r"], fq)
        check("fastx_artifacts_filter", ["-Q", "33"], fq, with_report=True)
        check("fastx_reverse_complement", ["-Q", "33"], fq)
        check("fastq_quality_converter", ["-Q", "33", "-n"], fq)
        check("fastq_quality_converter", ["-Q", "33", "-a"], fqnum)
        check("fastx_renamer", ["-Q", "33", "-n", "SEQ"], fq)
        check("fastx_renamer", ["-Q", "33", "-n", "COUNT"], fq)
        check("fastx_quality_stats", ["-Q", "33"], fq)
        check("fastx_quality_stats", ["-Q", "33", "-N"], fq)
        check("fastx_quality_stats", ["-Q", "64"], fq64)

        for ad in (b"CCTTAAGG", b"CTGTAGGCACCATCAAT",
                   b"CAATTGGTTAATCCCCCTATATA"):
            check("fastx_clipper",
                  ["-Q", "33", "-a", ad.decode(), "-l", "15", "-c"],
                  fq, with_report=True)
        check("fastx_clipper",
              ["-Q", "33", "-a", "CTGTAGGCACCATCAAT", "-n", "-k"], fq)
        check("fastx_clipper",
              ["-Q", "33", "-a", "CTGTAGGCACCATCAAT", "-d", "2",
               "-M", "10"], fq)
        check("fastx_clipper",
              ["-Q", "33", "-a", "CTGTAGGCACCATCAAT", "-l", "20"],
              fqlong)

        check("fasta_nucleotide_changer", ["-Q", "33", "-r"], fa)
        check("fastx_collapser", ["-Q", "33"], fac,
              canon=collapser_canon)
        check("fastx_trimmer", ["-Q", "33", "-f", "3", "-l", "400"],
              fqlong)
        check("fastq_quality_filter", ["-Q", "33", "-q", "20", "-p", "50"],
              fqlong)

    print("fuzz campaign: %d checks, %d mismatches, %.0f s"
          % (checks, fails, time.time() - t0))
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
