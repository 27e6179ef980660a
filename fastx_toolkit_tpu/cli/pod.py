"""fastx_pod — launch a tool across N worker processes (one per card)
with the multi-host environment wired up.

The multi-host execution model (see parallel.multihost) is activated by
environment variables so every tool keeps its reference-identical flag
surface; on a real pod each host runs the same command with its own
FASTX_TPU_PROCESS_ID.  This launcher covers the single-machine case —
functional testing, CPU scaling runs, and multi-GPU hosts — by spawning
N local worker processes itself, worker K on card K:

    fastx_pod -n 4 [--cpu] [--coordinator HOST:PORT] -- \
        fastx_quality_stats -i lane.fastq -o stats.txt

Each worker streams its own record-aligned byte range of the input;
per-read tools write FILE.shard-<k>-of-<n> outputs (in-order concat ==
single-process output), global tools (stats/collapser) write the merged
result from process 0 only, and -v reports print once with global
counters.
"""

from __future__ import annotations

import os
import subprocess
import sys

USAGE = """usage: fastx_pod [-n N] [--cpu] [--coordinator HOST:PORT] -- TOOL [ARGS...]

Run TOOL as N cooperating worker processes (multi-host execution model).

   -n N                 = number of worker processes (default 2).
   --cpu                = force the CPU backend in the workers (testing);
                          without it N may not exceed the number of cards.
   --pin-cores          = pin worker K to CPU core K via taskset
                          (single-machine scaling measurements).
   --coordinator H:P    = jax.distributed coordinator address
                          (default 127.0.0.1:19873).
   --                   = everything after this is the tool command line.
"""


def visible_cards() -> int:
    """Number of GPUs this host lets the workers use, found without
    opening a card: CUDA_VISIBLE_DEVICES when set, else nvidia-smi's
    list (0 when neither names a card)."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return len([d for d in vis.split(",") if d.strip()])
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    return len(out.split())


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    n = 2
    cpu = False
    pin_cores = False
    coordinator = "127.0.0.1:19873"
    tool_cmd = None
    i = 0
    while i < len(args):
        a = args[i]
        if a == "-n":
            i += 1
            n = int(args[i])
        elif a == "--cpu":
            cpu = True
        elif a == "--pin-cores":
            pin_cores = True
        elif a == "--coordinator":
            i += 1
            coordinator = args[i]
        elif a == "--":
            tool_cmd = args[i + 1 :]
            break
        elif a in ("-h", "--help"):
            sys.stdout.write(USAGE)
            return 1
        else:
            sys.stderr.write("fastx_pod: unknown option '%s'\n" % a)
            sys.stdout.write(USAGE)
            return 1
        i += 1
    if not tool_cmd:
        sys.stdout.write(USAGE)
        return 1
    if n < 1:
        sys.stderr.write("fastx_pod: -n must be >= 1\n")
        return 1
    if not cpu:
        cards = visible_cards()
        if n > cards:
            sys.stderr.write(
                "fastx_pod: -n %d needs one card per worker but %d are "
                "visible (use --cpu for CPU workers)\n" % (n, cards)
            )
            return 1

    # resolve a bare tool name against this package's bin/ shims when it
    # is not already on PATH (so `fastx_pod -- fastx_quality_stats ...`
    # works from a source checkout)
    import shutil

    if "/" not in tool_cmd[0] and shutil.which(tool_cmd[0]) is None:
        bindir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "bin")
        cand = os.path.join(bindir, tool_cmd[0])
        if os.path.exists(cand):
            tool_cmd[0] = cand

    procs = []
    for rank in range(n):
        env = dict(
            os.environ,
            FASTX_TPU_COORDINATOR=coordinator,
            FASTX_TPU_NUM_PROCESSES=str(n),
            FASTX_TPU_PROCESS_ID=str(rank),
        )
        if cpu:
            env["JAX_PLATFORMS"] = "cpu"
            env.pop("XLA_FLAGS", None)
            env.pop("JAX_LOCAL_DEVICE_IDS", None)
        else:
            # one card per worker (jax.distributed reads this): a JAX
            # process reserves most of the memory of every card it opens
            env["JAX_LOCAL_DEVICE_IDS"] = str(rank)
        env.pop("FASTX_TPU_NUM_SHARDS", None)
        env.pop("FASTX_TPU_SHARD_ID", None)
        cmd = tool_cmd
        if pin_cores:
            ncpu = os.cpu_count() or 1
            cmd = ["taskset", "-c", str(rank % ncpu), *tool_cmd]
        procs.append(subprocess.Popen(cmd, env=env))
    status = 0
    for p in procs:
        rc = p.wait()
        if rc != 0:
            status = rc
    return status


if __name__ == "__main__":
    sys.exit(main())
