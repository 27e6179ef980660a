"""Shared CLI layer: the fastx_args contract.

Reproduces /root/reference/src/libfastx/fastx_args.c:
* common flags ``-h -v -z -i -o -Q N`` prepended to each tool's options
  (option string "Q:zhvi:o:" + tool options, fastx_args.c:84-85)
* defaults: stdin/stdout, ASCII offset 33, report to stderr unless ``-o``
  was given, then stdout (fastx_args.c:39-44,87,120-126)
* ``-h`` prints the usage text and exits 1 (fastx_args.c:100-102)
* unknown flags: getopt's "invalid option" goes to stderr, then
  "use '-h' for usage information." to stdout, exit 1 (fastx_args.c:134-137)

plus err/errx-style fatal error reporting ("prog: message" to stderr,
exit 1) and the fork+gzip output compressor (fastx.c:214-248, here a
subprocess piping through the system gzip for byte-compatible -z output).
"""

from __future__ import annotations

import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.errors import FastxError

PACKAGE_STRING = "FASTX Toolkit 0.0.14"


class ExitWithStatus(Exception):
    def __init__(self, status: int):
        self.status = status


@dataclass
class CliContext:
    """Execution context, injectable for in-process testing."""

    prog: str
    stdin: object = None  # binary readable
    stdout: object = None  # binary writable
    stderr: object = None  # text writable
    stdout_text: object = None  # text writable (reports to stdout)

    def __post_init__(self):
        if self.stdin is None:
            self.stdin = sys.stdin.buffer
        if self.stdout is None:
            self.stdout = sys.stdout.buffer
        if self.stderr is None:
            self.stderr = sys.stderr
        if self.stdout_text is None:
            self.stdout_text = sys.stdout


@dataclass
class CommonArgs:
    input_filename: str = "-"
    output_filename: str = "-"
    verbose: bool = False
    compress: bool = False
    q_offset: int = 33
    report_to_stdout: bool = False
    tool_args: dict = field(default_factory=dict)


def _atoi(s: str) -> int:
    """C atoi: optional sign then digits; parses the longest valid prefix,
    0 if none."""
    s = s.lstrip(" \t\n\v\f\r")
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    return int(s[:j].replace("+", "", 1)) if s[0] == "+" else int(s[:j])


def c_atoi(s: str) -> int:
    return _atoi(s)


def c_strtoul(s: str) -> int:
    """strtoul(s, NULL, 10) as the tools use it (then stored in int)."""
    s = s.lstrip(" \t\n\v\f\r")
    neg = False
    i = 0
    if i < len(s) and s[i] in "+-":
        neg = s[i] == "-"
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    v = int(s[i:j])
    if neg:
        v = (2**64 - v) % 2**64
    # tools assign the result to int; emulate the narrowing
    v &= 0xFFFFFFFF
    if v >= 2**31:
        v -= 2**32
    return v


def getopt_loop(ctx: CliContext, argv, optstring: str):
    """A glibc-flavored getopt: yields (optchar, optarg); on errors prints
    glibc's message to stderr and yields ('?', None)."""
    takes_arg = {}
    i = 0
    while i < len(optstring):
        c = optstring[i]
        has = i + 1 < len(optstring) and optstring[i + 1] == ":"
        takes_arg[c] = has
        i += 2 if has else 1

    args = list(argv)
    pos = 0
    while pos < len(args):
        tok = args[pos]
        if tok == "--":
            return
        if not tok.startswith("-") or tok == "-":
            pos += 1  # GNU getopt permutes; our tools ignore operands
            continue
        ci = 1
        while ci < len(tok):
            c = tok[ci]
            if c not in takes_arg:
                print("%s: invalid option -- '%s'" % (ctx.prog, c), file=ctx.stderr)
                yield "?", None
                ci += 1
                continue
            if takes_arg[c]:
                if ci + 1 < len(tok):
                    yield c, tok[ci + 1 :]
                elif pos + 1 < len(args):
                    pos += 1
                    yield c, args[pos]
                else:
                    print(
                        "%s: option requires an argument -- '%s'" % (ctx.prog, c),
                        file=ctx.stderr,
                    )
                    yield "?", None
                ci = len(tok)
            else:
                yield c, None
                ci += 1
        pos += 1


def parse_cmdline(
    ctx: CliContext,
    argv,
    tool_options: str,
    tool_cb: Optional[Callable[[CommonArgs, str, Optional[str]], None]],
    usage: str,
) -> CommonArgs:
    """fastx_parse_cmdline (fastx_args.c:76-143)."""
    common = CommonArgs()
    tool_chars = set(tool_options.replace(":", ""))
    for opt, arg in getopt_loop(ctx, argv, "Q:zhvi:o:" + tool_options):
        if opt in tool_chars:
            tool_cb(common, opt, arg)
            continue
        if opt == "h":
            ctx.stdout_text.write(usage)
            raise ExitWithStatus(1)
        elif opt == "v":
            common.verbose = True
        elif opt == "z":
            common.compress = True
        elif opt == "i":
            common.input_filename = arg
        elif opt == "o":
            common.output_filename = arg
            common.report_to_stdout = True
        elif opt == "Q":
            common.q_offset = c_atoi(arg)
        else:
            ctx.stdout_text.write("use '-h' for usage information.\n")
            raise ExitWithStatus(1)
    return common


def errx(ctx: CliContext, message: str) -> "NoReturn":  # noqa: F821
    print("%s: %s" % (ctx.prog, message), file=ctx.stderr)
    raise ExitWithStatus(1)


class _NullBinaryStream:
    """Swallows output on non-primary processes of a merged writer."""

    def write(self, data) -> int:
        return len(data)

    def close(self) -> None:
        pass


class OutputWriter:
    """File/stdout writer with optional gzip child, like
    open_output_compressor (fastx.c:214-248).

    Multi-host roles: ``role="shard"`` (per-read streaming tools) makes
    each process write its own record-range shard — file outputs get a
    ``.shard-<k>-of-<n>`` suffix whose in-order concatenation equals the
    single-process output; stdout outputs go to each process's own
    stdout.  ``role="merged"`` (global operators: stats, collapser) has
    only process 0 write the collectively merged result to the plain
    filename; in shard-only mode (no process group to merge over) the
    partial result is written per shard like role="shard".
    """

    def __init__(self, ctx: CliContext, common: CommonArgs, role: str = "shard"):
        from ..parallel import multihost

        self.ctx = ctx
        self._gzip = None
        self._file = None
        filename = common.output_filename
        info = multihost.shard_info()
        if info.active:
            if role == "merged" and info.collective:
                if not info.is_primary:
                    self.stream = _NullBinaryStream()
                    return
            elif filename != "-":
                filename = multihost.shard_suffix(filename, info)
        if common.compress:
            if filename == "-":
                self._gzip = subprocess.Popen(["gzip"], stdin=subprocess.PIPE, stdout=ctx.stdout)
            else:
                self._file = self._open(filename)
                self._gzip = subprocess.Popen(["gzip"], stdin=subprocess.PIPE, stdout=self._file)
            self.stream = self._gzip.stdin
        elif filename == "-":
            self.stream = ctx.stdout
        else:
            self._file = self._open(filename)
            self.stream = self._file

    def _open(self, filename):
        try:
            return open(filename, "wb")
        except OSError as e:
            print(
                "%s: Failed to create output file (%s): %s"
                % (self.ctx.prog, filename, e.strerror),
                file=self.ctx.stderr,
            )
            raise ExitWithStatus(1)

    def write(self, data: bytes):
        self.stream.write(data)

    def close(self):
        if self._gzip is not None:
            self._gzip.stdin.close()
            self._gzip.wait()
        elif self.stream is not self.ctx.stdout:
            self.stream.close()
        if self._file is not None:
            self._file.close()


def report_stream(ctx: CliContext, common: CommonArgs):
    from ..parallel import multihost

    info = multihost.shard_info()
    if info.active and info.collective and not info.is_primary:
        # counters are allsum'd across the process group; only process 0
        # prints the (globally merged) report.  Shard-only mode instead
        # keeps per-shard reports on each process's own stderr/stdout.
        return multihost.NullTextStream()
    return ctx.stdout_text if common.report_to_stdout else ctx.stderr


# JAX's persistent compile cache when JAX_COMPILATION_CACHE_DIR is unset:
# a fixed directory inside the checkout (the path is part of the key)
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache() -> None:
    """Keep JAX's persistent compile cache in COMPILE_CACHE_DIR unless
    JAX_COMPILATION_CACHE_DIR is set (JAX reads that variable itself), so
    repeated CLI invocations reuse compiled programs."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def run_tool_main(tool_main: Callable[[CliContext, list], int], argv=None) -> int:
    """Process-level wrapper: maps FastxError/ExitWithStatus to exit codes."""
    from ..parallel import multihost

    # multi-host process group (FASTX_TPU_COORDINATOR/...) must come up
    # before any jax backend is touched
    multihost.initialize()
    configure_compile_cache()
    ctx = CliContext(prog=os.path.basename(sys.argv[0]))
    args = list(sys.argv[1:] if argv is None else argv)
    try:
        status = tool_main(ctx, args)
    except ExitWithStatus as e:
        status = e.status
    except FastxError as e:
        print("%s: %s" % (ctx.prog, e), file=ctx.stderr)
        status = e.status
    except BrokenPipeError:
        status = 1
    try:
        sys.stdout.flush()
    except BrokenPipeError:
        status = 1
    return status
