"""Native (C++) host runtime components.

The counting hot path runs on the device, but the host must parse and encode
FASTQ fast enough to feed it; the pure-Python reader
tops out far below that.  This package wraps `fastx_reader.cpp` — the
analogue of the reference's kseq parser (vendor/kseq.h:178-219)
— via ctypes.  The .so is built on demand with g++ (see Makefile); when
neither a prebuilt .so nor a compiler is available every caller falls back
to the Python reader transparently.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))


def _so_path() -> str:
    """Machine-signature-suffixed .so name: the build uses -march=native,
    so a binary built on a different CPU generation would SIGILL on its
    first specialized instruction rather than fail to load — keying the
    filename by the CPU signature makes a foreign .so invisible (forcing
    a local rebuild) instead of a latent crash."""
    from ntsm_tpu.utils.machine import machine_signature

    return os.path.join(_DIR, f"libntsm_fastx-{machine_signature()}.so")


_lock = threading.Lock()
_lib = None
_tried = False


def _build(so: str) -> bool:
    # build into a pid-unique name, then atomically rename: concurrent
    # processes (a CLI run racing a test run) must never dlopen or
    # overwrite a half-written .so
    tmp = f"{os.path.basename(so)}.tmp{os.getpid()}"
    try:
        res = subprocess.run(
            ["make", "-C", _DIR, "-s", f"SO={tmp}"],
            capture_output=True,
            text=True,
            timeout=120,
        )
        if res.returncode != 0:
            print(
                f"ntsm_tpu.native: build failed, using Python reader\n{res.stderr}",
                file=sys.stderr,
            )
            return False
        os.replace(os.path.join(_DIR, tmp), so)
        return True
    except Exception as e:  # no make/g++ in this environment
        print(
            f"ntsm_tpu.native: cannot build ({e}), using Python reader",
            file=sys.stderr,
        )
        return False
    finally:
        try:
            os.unlink(os.path.join(_DIR, tmp))
        except OSError:
            pass


def load():
    """Return the loaded native library, building it if needed, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("NTSM_NO_NATIVE"):
            return None
        so = _so_path()
        _srcs = ("fastx_reader.cpp", "exact_pairs.cpp")
        if not os.path.exists(so) or os.path.getmtime(so) < max(
            os.path.getmtime(os.path.join(_DIR, s)) for s in _srcs
        ):
            if not _build(so):
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            print(f"ntsm_tpu.native: load failed ({e})", file=sys.stderr)
            return None
        lib.ntsm_reader_open.restype = ctypes.c_void_p
        lib.ntsm_reader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.ntsm_reader_close.argtypes = [ctypes.c_void_p]
        lib.ntsm_reader_next_batch.restype = ctypes.c_int
        lib.ntsm_reader_next_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.ntsm_pack_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        if hasattr(lib, "ntsm_canonical_hashes"):
            lib.ntsm_canonical_hashes.argtypes = [
                ctypes.c_void_p,
                ctypes.c_long,
                ctypes.c_int,
                ctypes.c_void_p,
                ctypes.c_void_p,
            ]
        if hasattr(lib, "ntsm_parse_counts2"):
            lib.ntsm_parse_counts2.restype = ctypes.c_long
            lib.ntsm_parse_counts2.argtypes = [
                ctypes.c_char_p,
                ctypes.c_long,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_long,
                ctypes.c_void_p,
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long),
            ]
        if hasattr(lib, "ntsm_parse_counts3"):
            lib.ntsm_parse_counts3.restype = ctypes.c_long
            lib.ntsm_parse_counts3.argtypes = [
                ctypes.c_char_p,  # buf
                ctypes.c_long,  # len
                ctypes.c_void_p,  # wa u16 row
                ctypes.c_void_p,  # wb u16 row
                ctypes.c_void_p,  # site_acc i64 [L,4]
                ctypes.c_void_p,  # samp_acc i64 [2]
                ctypes.c_void_p,  # dist i64 [L,2] or NULL
                ctypes.c_long,  # cap
                ctypes.c_void_p,  # ids_out u8
                ctypes.c_long,  # ids_cap
                ctypes.POINTER(ctypes.c_long),  # ids_len
                ctypes.POINTER(ctypes.c_long),  # tk
                ctypes.POINTER(ctypes.c_long),  # ks
            ]
        if hasattr(lib, "ntsm_exact_pairs"):
            lib.ntsm_exact_pairs.restype = None
            lib.ntsm_exact_pairs.argtypes = [
                ctypes.c_void_p,  # A f64 [N,L]
                ctypes.c_void_p,  # B f64 [N,L]
                ctypes.c_void_p,  # CLS u8 [N,L]
                ctypes.c_void_p,  # S f64 [N,L] s_single
                ctypes.c_long,  # N
                ctypes.c_long,  # L
                ctypes.c_double,  # min_cov
                ctypes.c_void_p,  # ii i32 [P]
                ctypes.c_void_p,  # jj i32 [P]
                ctypes.c_long,  # P
                ctypes.c_void_p,  # joint f64 [P]
                ctypes.c_void_p,  # ss f64 [P]
                ctypes.c_void_p,  # tallies i64 [P,8]
            ]
        if hasattr(lib, "ntsm_project_exact"):
            lib.ntsm_project_exact.restype = None
            lib.ntsm_project_exact.argtypes = [
                ctypes.c_void_p,  # vals f64 [n, L]
                ctypes.c_void_p,  # rotT long double [L, dim], C-contig
                ctypes.c_long,  # n
                ctypes.c_long,  # L
                ctypes.c_long,  # dim
                ctypes.c_void_p,  # out f64 [n, dim]
            ]
        if hasattr(lib, "ntsm_breaks_sidecar"):
            lib.ntsm_breaks_sidecar.restype = ctypes.c_int
            lib.ntsm_breaks_sidecar.argtypes = [
                ctypes.c_void_p,  # codes u8 [B, L]
                ctypes.c_void_p,  # lengths i32 [B]
                ctypes.c_long,  # B
                ctypes.c_long,  # L
                ctypes.c_int,  # maxb
                ctypes.c_void_p,  # side u8 [B, 2+2*maxb] out
            ]
        if hasattr(lib, "ntsm_quantize_vals"):
            lib.ntsm_quantize_vals.restype = None
            lib.ntsm_quantize_vals.argtypes = [
                ctypes.c_void_p,  # a counts [m, L]
                ctypes.c_void_p,  # b counts [m, L]
                ctypes.c_int,  # dsize 1/2/4/8
                ctypes.c_long,  # m
                ctypes.c_long,  # L
                ctypes.c_long,  # a row pitch (elements)
                ctypes.c_long,  # b row pitch (elements)
                ctypes.c_void_p,  # norm f64 [L]
                ctypes.c_double,  # min_cov
                ctypes.c_void_p,  # vals f64 [m, L] out
            ]
        if hasattr(lib, "ntsm_format_eval_rows"):
            lib.ntsm_format_eval_rows.restype = ctypes.c_long
            lib.ntsm_format_eval_rows.argtypes = [
                ctypes.c_long,
                ctypes.c_void_p,  # ii i32
                ctypes.c_void_p,  # jj i32
                ctypes.c_void_p,  # f3 f64 [P,3]
                ctypes.c_void_p,  # i9 i64 [P,9]
                ctypes.c_void_p,  # same u8
                ctypes.c_void_p,  # dist f64 or None (-a prints "-1")
                ctypes.c_void_p,  # samp bytes [n_samp,6] width w
                ctypes.c_long,  # samp_w
                ctypes.c_long,  # n_samp
                ctypes.c_void_p,  # outbuf
                ctypes.c_long,  # outcap
            ]
        if hasattr(lib, "ntsm_parse_counts"):
            lib.ntsm_parse_counts.restype = ctypes.c_long
            lib.ntsm_parse_counts.argtypes = [
                ctypes.c_char_p,
                ctypes.c_long,
                ctypes.c_void_p,
                ctypes.c_long,
                ctypes.c_void_p,
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long),
            ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None
