"""Command-line interface.

``ntsm count|eval|vcf|sitegen`` with flags compatible with the reference
binaries ntsmCount / ntsmEval / ntsmVCF / ntsmSiteGen
(src/ntSeqMatchCount.cpp, src/ntSeqMatchEval.cpp, src/ntSeqMatchVCF.cpp,
ntsm-scripts/makefile).
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from ntsm_tpu.utils.device import NoAcceleratorError

    try:
        return _dispatch(list(sys.argv[1:] if argv is None else argv))
    except NoAcceleratorError as e:
        print(e, file=sys.stderr)
        return 1


def _dispatch(argv) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print(
            "Usage: ntsm <count|eval|vcf|sitegen> [OPTIONS]\n"
            "Sample-swap detection on the GPU (ntsm-compatible).",
            file=sys.stderr,
        )
        return 0 if argv else 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "count":
        from ntsm_tpu.cli.count_cmd import run

        return run(rest)
    if cmd == "eval":
        from ntsm_tpu.cli.eval_cmd import run

        return run(rest)
    if cmd == "vcf":
        from ntsm_tpu.cli.vcf_cmd import run

        return run(rest)
    if cmd == "sitegen":
        from ntsm_tpu.cli.sitegen_cmd import run

        return run(rest)
    print(f"ntsm: unknown command {cmd!r}", file=sys.stderr)
    return 1
