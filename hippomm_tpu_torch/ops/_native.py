"""Build-at-first-use loader for the port's native code (csrc/).

Four shared libraries with plain C interfaces, loaded with ctypes:

  * the Hopper kernels (csrc/*.cu → one .so; K1/K4 and K2/K3 have a bf16
    source and an fp32 one): every `.cu` source compiles
    with its own `nvcc` process, all started together, then one link step.
    Targets sm_90a. Needs `nvcc` (PATH or /usr/local/cuda/bin) — there is no
    fallback: a wrapper handed a CUDA tensor launches its kernel or raises.
  * the Pillow-exact bicubic resize (csrc/media_resize.cpp, host C++), built
    with the host C++ compiler. None when no compiler is found; the caller
    then resamples with PIL, as the JAX package does without its shim.
  * the host media shim (csrc/media_jpeg.cpp: libjpeg codec, MJPEG-AVI
    reader and writer), built with the host C++ compiler against -ljpeg.
    None when there is no compiler, or no jpeglib.h / libjpeg: JPEG then
    goes through PIL and the AVI reader and writer raise, as the JAX
    package does without its shim.
  * the libav shim (csrc/media_libav.cpp: .mp4/.mov/.mkv/.webm and non-MJPEG
    .avi demux and decode, container audio, the libav writer), built with
    the host C++ compiler against libavformat/codec/util, swscale and
    swresample, on its own so a host with only one of libjpeg and libav
    still gets that one. None where it does not build or load: the libav
    readers and writers then raise RuntimeError, as the JAX package's do
    without its shim.

Outputs go to `_build/` inside the package (listed in .gitignore), named by
a hash of sources, headers and flags, so an edited source or header never
loads a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import List, Optional

logger = logging.getLogger(__name__)

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_CSRC), "_build")
KERNEL_SOURCES = ("flash_mha.cu", "flash_mha_f32.cu", "fused_mlp.cu", "fused_mlp_f32.cu", "topk_cosine.cu")
KERNEL_HEADERS = ("hopper.cuh",)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_kernels: Optional[ctypes.CDLL] = None
_resize: Optional[ctypes.CDLL] = None
_resize_tried = False
_media: Optional[ctypes.CDLL] = None
_media_tried = False
_libav: Optional[ctypes.CDLL] = None
_libav_tried = False
_count_lock = threading.Lock()
_thread_state = threading.local()
#: ptxas register / shared-memory report of the last kernel build
build_log: str = ""


def _digest(paths: List[str], flags: List[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def bind_thread(device) -> None:
    """Make `device`'s primary CUDA context current in the calling thread.
    The kernels' C entries reach the driver API (tensor-map encodes) before
    any runtime call that would bind it, so a thread whose first CUDA work
    is a kernel call (its tensors from the caching allocator, no runtime
    call yet) would get CUDA_ERROR_INVALID_CONTEXT. Once per thread and
    device; a stream query is the cheapest runtime call that binds it."""
    bound = getattr(_thread_state, "bound", None)
    if bound is None:
        bound = _thread_state.bound = set()
    if device.index not in bound:
        import torch

        torch.cuda.current_stream(device).query()
        bound.add(device.index)


def count_launch(fn, fp32: bool = False) -> None:
    """Add one to a kernel wrapper's `launches` count, and for its fp32
    kernel to `launches_f32` too. Under a lock: the ingest launches kernels
    from more than one thread (the vision stream's worker beside the
    engine), and a bare `+=` can lose a count."""
    with _count_lock:
        fn.launches += 1
        if fp32:
            fn.launches_f32 += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): cannot build csrc/*.cu")


def _build_kernels(lib_path: str) -> None:
    global build_log
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, objs = [], []
    for src in KERNEL_SOURCES:
        obj = f"{lib_path}.{os.getpid()}.{os.path.splitext(src)[0]}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", os.path.join(_CSRC, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    logs, failed = [], []
    for src, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    tmp = f"{lib_path}.tmp{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-shared", "-o", tmp, *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)


def kernels() -> ctypes.CDLL:
    """The Hopper kernel library, built on first call (seconds with nvcc)."""
    global _kernels
    with _lock:
        if _kernels is not None:
            return _kernels
        # the shared headers too: an edited header must not load a stale build
        srcs = [os.path.join(_CSRC, s) for s in (*KERNEL_SOURCES, *KERNEL_HEADERS)]
        lib_path = os.path.join(BUILD_DIR, f"libhippomm_kernels_{_digest(srcs, NVCC_FLAGS)}.so")
        if not os.path.exists(lib_path):
            _build_kernels(lib_path)
        lib = ctypes.CDLL(lib_path)
        vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        lib.hmm_flash_mha_bf16.argtypes = [vp, vp, vp, vp, *[i32] * 7, f32, vp]
        lib.hmm_flash_mha_bf16.restype = i32
        lib.hmm_flash_mha_bthd_bf16.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32,
                                                *[i64] * 9, i32, i32, f32, vp]
        lib.hmm_flash_mha_bthd_bf16.restype = i32
        lib.hmm_flash_mha_smem_bytes.argtypes = [i32]
        lib.hmm_flash_mha_smem_bytes.restype = i32
        lib.hmm_flash_mha_f32.argtypes = [vp, vp, vp, vp, *[i32] * 5, *[i64] * 12, i32, i32, i32, f32, vp]
        lib.hmm_flash_mha_f32.restype = i32
        lib.hmm_flash_mha_f32_smem_bytes.argtypes = [i32]
        lib.hmm_flash_mha_f32_smem_bytes.restype = i32
        lib.hmm_fused_mlp_bf16.argtypes = [*[vp] * 8, *[i32] * 5, vp]
        lib.hmm_fused_mlp_bf16.restype = i32
        lib.hmm_fused_mlp_tanh_bf16.argtypes = [*[vp] * 8, *[i32] * 5, vp]
        lib.hmm_fused_mlp_tanh_bf16.restype = i32
        lib.hmm_fused_ln_mlp_residual_bf16.argtypes = [*[vp] * 12, *[i32] * 5, f32, vp]
        lib.hmm_fused_ln_mlp_residual_bf16.restype = i32
        lib.hmm_fused_mlp_smem_bytes.argtypes = [i32]
        lib.hmm_fused_mlp_smem_bytes.restype = i32
        lib.hmm_fused_mlp_f32.argtypes = [*[vp] * 9, *[i32] * 5, vp]
        lib.hmm_fused_mlp_f32.restype = i32
        lib.hmm_fused_ln_mlp_residual_f32.argtypes = [*[vp] * 12, *[i32] * 5, f32, vp]
        lib.hmm_fused_ln_mlp_residual_f32.restype = i32
        lib.hmm_fused_mlp_f32_smem_bytes.argtypes = [i32]
        lib.hmm_fused_mlp_f32_smem_bytes.restype = i32
        lib.hmm_topk_cosine_f32.argtypes = [vp, vp, *[i32] * 7, vp, vp, vp]
        lib.hmm_topk_cosine_f32.restype = i32
        _kernels = lib
        return lib


def resize_lib() -> Optional[ctypes.CDLL]:
    """The host bicubic resize+crop library, or None without a C++ compiler."""
    global _resize, _resize_tried
    with _lock:
        if _resize is not None or _resize_tried:
            return _resize
        _resize_tried = True
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            return None
        src = os.path.join(_CSRC, "media_resize.cpp")
        flags = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]
        lib_path = os.path.join(BUILD_DIR, f"libhmm_resize_{_digest([src], flags)}.so")
        if not os.path.exists(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib_path}.tmp{os.getpid()}"
            subprocess.run([cxx, *flags, "-o", tmp, src], check=True, capture_output=True)
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.hmm_resize_bicubic_crop_batch.restype = ctypes.c_int
        lib.hmm_resize_bicubic_crop_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]
        _resize = lib
        return lib


def _host_lib(src_name: str, name: str, libs: List[str], what: str) -> Optional[ctypes.CDLL]:
    """Build csrc/`src_name` with the host C++ compiler against `libs` (once
    per source hash) and load it; None where there is no compiler, the build
    fails (headers or libraries missing) or the library does not load (e.g.
    a build carried from a host whose shared libraries this one lacks).
    Called under _lock."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        logger.warning("%s: no C++ compiler", what)
        return None
    src = os.path.join(_CSRC, src_name)
    flags = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]
    lib_path = os.path.join(BUILD_DIR, f"lib{name}_{_digest([src], flags + libs)}.so")
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.tmp{os.getpid()}"
        build = subprocess.run([cxx, *flags, "-o", tmp, src, *libs], capture_output=True, text=True)
        if build.returncode != 0:
            logger.warning("%s: did not build (%s)", what,
                           build.stderr.strip().splitlines()[-1:] or build.returncode)
            return None
        os.replace(tmp, lib_path)
    try:
        return ctypes.CDLL(lib_path)
    except OSError as e:
        logger.warning("%s: does not load (%s)", what, e)
        return None


def media_lib() -> Optional[ctypes.CDLL]:
    """The host media shim (libjpeg codec and MJPEG-AVI container), or None
    where no C++ compiler, jpeglib.h or libjpeg is found: JPEG then goes
    through PIL and the AVI reader and writer raise."""
    global _media, _media_tried
    with _lock:
        if _media is not None or _media_tried:
            return _media
        _media_tried = True
        lib = _host_lib("media_jpeg.cpp", "hmm_media", ["-ljpeg"],
                        "media shim (JPEG through PIL, no AVI)")
        if lib is None:
            return None
        vp, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
        pi32 = ctypes.POINTER(ctypes.c_int)
        lib.hmm_jpeg_decode.restype = i32
        lib.hmm_jpeg_decode.argtypes = [vp, ctypes.c_size_t, vp, pi32, pi32]
        lib.hmm_jpeg_encode.restype = i32
        lib.hmm_jpeg_encode.argtypes = [vp, i32, i32, i32, vp, ctypes.POINTER(ctypes.c_size_t)]
        lib.hmm_jpeg_decode_batch.restype = i32
        lib.hmm_avi_open.restype = vp
        lib.hmm_avi_open.argtypes = [ctypes.c_char_p]
        lib.hmm_avi_info.argtypes = [vp, pi32, pi32, ctypes.POINTER(f64), ctypes.POINTER(i64)]
        lib.hmm_avi_read_indices.restype = i32
        lib.hmm_avi_read_indices.argtypes = [vp, vp, i64, vp]
        lib.hmm_avi_close.argtypes = [vp]
        lib.hmm_avi_writer_open.restype = vp
        lib.hmm_avi_writer_open.argtypes = [ctypes.c_char_p, i32, i32, f64, i32]
        lib.hmm_avi_writer_write.restype = i32
        lib.hmm_avi_writer_write.argtypes = [vp, vp]
        lib.hmm_avi_writer_close.restype = i32
        lib.hmm_avi_writer_close.argtypes = [vp]
        _media = lib
        return lib


LIBAV_LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale", "-lswresample", "-lpthread"]


def media_libav_lib() -> Optional[ctypes.CDLL]:
    """The libav shim (csrc/media_libav.cpp: container demux and decode,
    audio demux and resample, H.264/MPEG-4 + AAC encode), or None where no
    C++ compiler, libav headers or libav libraries are found: the libav
    readers and writers then raise RuntimeError naming the missing library."""
    global _libav, _libav_tried
    with _lock:
        if _libav is not None or _libav_tried:
            return _libav
        _libav_tried = True
        lib = _host_lib("media_libav.cpp", "hmm_libav", LIBAV_LIBS,
                        "libav shim (no .mp4/.mov/.mkv/.webm, no container audio)")
        if lib is None:
            return None
        vp, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
        pi32, pi64, pf64 = ctypes.POINTER(i32), ctypes.POINTER(i64), ctypes.POINTER(f64)
        for fn, res, args in (
            ("hmm_av_open", vp, [ctypes.c_char_p]),
            ("hmm_av_info", i32, [vp, pi32, pi32, pf64, pf64, pi64, pi32]),
            ("hmm_av_read_rgb_indices", i32, [vp, vp, i64, vp]),
            ("hmm_av_read_gray_indices", i32, [vp, vp, i64, i32, i32, vp]),
            ("hmm_av_read_block_hold", i32, [vp, vp, i64, i32, i32, i32, vp, ctypes.POINTER(vp)]),
            ("hmm_av_block_take_rgb", i32, [vp, vp, i64, vp]),
            ("hmm_av_block_free", None, [vp]),
            ("hmm_av_close", None, [vp]),
            ("hmm_av_audio_decode", vp, [ctypes.c_char_p, f64, f64, pi64]),
            ("hmm_av_audio_take", i32, [vp, vp]),
            ("hmm_av_audio_free", None, [vp]),
            ("hmm_av_writer_open", vp, [ctypes.c_char_p, i32, i32, f64, i32, ctypes.c_char_p]),
            ("hmm_av_writer_video", i32, [vp, vp]),
            ("hmm_av_writer_audio", i32, [vp, vp, i64]),
            ("hmm_av_writer_close", i32, [vp]),
        ):
            f = getattr(lib, fn)
            f.restype, f.argtypes = res, args
        _libav = lib
        return lib
