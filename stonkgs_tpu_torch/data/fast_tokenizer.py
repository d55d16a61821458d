"""ctypes frontend of the C++ WordPiece tokenizer (``csrc/wordpiece.cpp``).

The port's copy of the JAX package's ``data/fast_tokenizer.py``: the same
surface as :class:`~stonkgs_tpu_torch.data.wordpiece.BertTokenizer`, with
the batch encode in native code.  The shared library and its generated
Unicode tables are built with g++ at first use into ``csrc/build/``
(nothing is built at import).  Without a compiler it falls back to the
pure-Python tokenizer with a warning; :attr:`FastBertTokenizer.is_native`
says which one runs, so a caller that needs the native one can insist.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
import warnings
from pathlib import Path
from typing import Iterable, Optional, Tuple

import numpy as np

from stonkgs_tpu_torch.data.wordpiece import BertTokenizer as PyBertTokenizer

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _stale(target: Path, *deps: Path) -> bool:
    return (not target.exists()
            or target.stat().st_mtime < max(d.stat().st_mtime for d in deps))


def _build_to(target: Path, cmd) -> None:
    """Run ``cmd`` (its output path is ``{out}``) into a file of this
    process, then move it onto ``target``: processes that build at once
    never load a half-written file."""
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    subprocess.run([str(tmp) if c == "{out}" else c for c in cmd],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, target)


def _load_lib() -> Optional[ctypes.CDLL]:
    """Build (if stale) and load ``libwordpiece.so``; None if that fails."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        src, gen = CSRC / "wordpiece.cpp", CSRC / "gen_unicode_tables.py"
        header, so = BUILD_DIR / "unicode_tables.h", BUILD_DIR / "libwordpiece.so"
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            if _stale(header, gen):
                _build_to(header, [sys.executable, str(gen), "{out}"])
            if _stale(so, src, header):
                _build_to(so, ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                               "-pthread", "-I", str(BUILD_DIR), "-o", "{out}",
                               str(src)])
            lib = ctypes.CDLL(str(so))
        except subprocess.CalledProcessError as e:
            warnings.warn(f"native tokenizer did not build, using the Python "
                          f"one: {e.stderr[-2000:]}")
            _lib_failed = True
            return None
        except OSError as e:   # no g++, or the library does not load
            warnings.warn(f"native tokenizer unavailable, using the Python one: {e}")
            _lib_failed = True
            return None
        lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_free.argtypes = [ctypes.c_void_p]
        lib.wp_free.restype = None
        lib.wp_vocab_size.argtypes = [ctypes.c_void_p]
        lib.wp_vocab_size.restype = ctypes.c_int32
        lib.wp_token_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.wp_token_id.restype = ctypes.c_int32
        lib.wp_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.wp_encode_batch.restype = None
        _lib = lib
        return lib


class FastBertTokenizer:
    """C++-backed tokenizer with the surface of ``data.wordpiece.BertTokenizer``."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 n_threads: Optional[int] = None):
        lib = _load_lib()
        self._py = None
        self._handle = None
        self._vocab_file = str(vocab_file)
        self._do_lower_case = do_lower_case
        self.n_threads = n_threads or min(os.cpu_count() or 1, 16)
        if lib is not None:
            self._lib = lib
            self._handle = lib.wp_create(self._vocab_file.encode(), int(do_lower_case))
        if self._handle is None:
            self._py = PyBertTokenizer(self._vocab_file, do_lower_case)
            return
        self.vocab_size = int(lib.wp_vocab_size(self._handle))
        self.unk_id = int(lib.wp_token_id(self._handle, b"[UNK]"))
        self.cls_id = int(lib.wp_token_id(self._handle, b"[CLS]"))
        self.sep_id = int(lib.wp_token_id(self._handle, b"[SEP]"))
        self.pad_id = int(lib.wp_token_id(self._handle, b"[PAD]"))
        mask = int(lib.wp_token_id(self._handle, b"[MASK]"))
        self.mask_id = mask if mask >= 0 else None

    def __getattr__(self, name):
        # What the C interface does not expose (tokenize,
        # convert_tokens_to_ids, vocab, ...) goes to a Python tokenizer
        # built on first use, so both modes have the same surface.
        if name.startswith("_"):
            raise AttributeError(name)
        if self._py is None:
            object.__setattr__(self, "_py",
                               PyBertTokenizer(self._vocab_file, self._do_lower_case))
        return getattr(self._py, name)

    def __del__(self):
        h = getattr(self, "_handle", None)
        if h:
            self._lib.wp_free(h)

    @property
    def is_native(self) -> bool:
        """True when the C++ library encodes; False on the Python fallback."""
        return self._handle is not None

    def encode(self, text: str, max_length: int) -> Tuple[list, list]:
        """Encode one text to ids with padding/truncation to max_length."""
        ids, mask = self.encode_batch([text], max_length)
        return ids[0].tolist(), mask[0].tolist()

    def encode_batch(self, texts: Iterable[str], max_length: int):
        """Encode a list of texts; returns (ids, attention_mask) int32 arrays."""
        if self._handle is None:
            return self._py.encode_batch(texts, max_length)
        texts = [t.encode("utf-8") for t in texts]
        n = len(texts)
        ids = np.zeros((n, max_length), np.int32)
        mask = np.zeros((n, max_length), np.int32)
        arr = (ctypes.c_char_p * n)(*texts)
        lens = np.asarray([len(t) for t in texts], np.int64)
        self._lib.wp_encode_batch(
            self._handle, arr,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, max_length, self.n_threads,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return ids, mask
