"""In-process tool invocation helper for parity tests."""

import io
import os

from fastx_toolkit_tpu.cli.common import CliContext, ExitWithStatus
from fastx_toolkit_tpu.core.errors import FastxError

TEST_DATA = "/root/reference/galaxy/test-data"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fixture(name: str) -> bytes:
    with open(os.path.join(TEST_DATA, name), "rb") as f:
        return f.read()


class Result:
    def __init__(self, status, stdout, stderr, report):
        self.status = status
        self.stdout = stdout
        self.stderr = stderr
        self.report = report


def run_tool(tool_module, argv, stdin: bytes = b"", prog=None) -> Result:
    out = io.BytesIO()
    err = io.StringIO()
    rep = io.StringIO()
    ctx = CliContext(
        prog=prog or tool_module.__name__.rsplit(".", 1)[-1],
        stdin=io.BytesIO(stdin),
        stdout=out,
        stderr=err,
        stdout_text=rep,
    )
    try:
        status = tool_module.tool_main(ctx, list(argv))
    except ExitWithStatus as e:
        status = e.status
    except FastxError as e:
        err.write("%s: %s\n" % (ctx.prog, e))
        status = e.status
    return Result(status, out.getvalue(), err.getvalue(), rep.getvalue())
