"""Build the CUDA kernels in ``repro_torch/csrc`` and launch them.

One path for every kernel. Its source is either printed per plan by
``scan_codegen`` around ``csrc/scan_spec.cuh`` (the scan kernel,
``qap_count`` and ``fused_scan``) or a fixed file of ``csrc/``
(``hll_fold.cu``, a ``FixedSource``). It is compiled for ``sm_90a`` on
first use, in-process with NVRTC (``libnvrtc`` of the CUDA toolkit),
into a cubin cached in the process and in ``build/kernels/`` at the root
of the checkout (``.gitignore`` lists ``build/``), under a file name
that carries a digest of the source, the headers and the flags, so an
edited kernel is rebuilt and a stale one is never loaded. The cubin is
loaded with the CUDA driver API into the primary context of the card
and launched with ``cuLaunchKernel`` on torch's current stream
(``SpecKernel``). NVRTC runs outside any lock, so sources compile in
parallel (``compile_scans``).

Nothing here runs at import time: this module is imported on machines
without a card or a compiler, where only the plain torch versions run.

The path records the spans ``kernel.source`` (the scan kernel's),
``kernel.get``, ``kernel.module`` and ``kernel.launch``
(``repro_torch.tracing``). Its misses (a plan printed, a cubin read or
compiled with NVRTC, a module loaded onto a card) are
``scan_codegen.BUILD_BUSY`` blocks: the counter of that name holds the
wall time in which at least one of them ran, in any thread.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import pathlib
import threading
import time

from .. import tracing
from . import scan_codegen

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parents[2] / "build" / "kernels"
SPEC_HEADERS = ("scan_common.cuh", "scan_spec.cuh")
NVRTC_FLAGS = ("--gpu-architecture=sm_90a", "-std=c++17",
               "--ptxas-options=-v")
# NVRTC compiles, cubins read from the disk cache, kernels found in the
# process's cache (or being compiled there by another thread)
spec_stats = {"compiled": 0, "loaded": 0, "hits": 0}

_spec_lock = threading.Lock()
_specs: dict[str, "SpecKernel"] = {}
_pending: dict[str, concurrent.futures.Future] = {}
_runtime_libs: dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
_contexts: dict[int, ctypes.c_void_p] = {}
_P, _I = ctypes.c_void_p, ctypes.c_int

# CUDA driver API enums (cuda.h)
_FUNC_MAX_THREADS, _FUNC_STATIC_SHARED, _FUNC_LOCAL, _FUNC_REGS = 0, 1, 3, 4
_FUNC_MAX_DYNAMIC_SHARED, _FUNC_CARVEOUT = 8, 9
_DEV_SM_COUNT = 16


@dataclasses.dataclass(frozen=True)
class FixedSource:
    """A kernel file of ``csrc/`` as ``spec_kernel`` takes it: one cubin
    for every call, which passes what varies as the kernel's arguments."""
    source: str
    digest: str                 # sha256 of ``source``
    entry: str                  # the ``extern "C"`` kernel's name
    threads: int                # a block (its ``__launch_bounds__``)
    smem_bytes: int             # the most dynamic shared memory a launch takes
    row_bytes: int              # bytes of a row the kernel reads


def _nvrtc() -> ctypes.CDLL:
    with _lib_lock:
        return _runtime_libs.get("nvrtc") or _load_nvrtc()


def _load_nvrtc() -> ctypes.CDLL:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    found = sorted(pathlib.Path(CUDA_HOME, "lib64").glob("libnvrtc.so*"),
                   key=lambda f: len(f.name))
    if not found:
        raise RuntimeError(f"no libnvrtc under {CUDA_HOME}/lib64")
    lib = ctypes.CDLL(str(found[0]))
    P, S, C = ctypes.POINTER, ctypes.c_size_t, ctypes.c_char_p
    for fn, args in (
            ("nvrtcCreateProgram", [P(_P), C, C, _I, P(C), P(C)]),
            ("nvrtcCompileProgram", [_P, _I, P(C)]),
            ("nvrtcGetProgramLogSize", [_P, P(S)]),
            ("nvrtcGetProgramLog", [_P, C]),
            ("nvrtcGetCUBINSize", [_P, P(S)]),
            ("nvrtcGetCUBIN", [_P, C]),
            ("nvrtcDestroyProgram", [P(_P)])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = _I
    lib.nvrtcGetErrorString.argtypes = [_I]
    lib.nvrtcGetErrorString.restype = C
    _runtime_libs["nvrtc"] = lib
    return lib


def _cuda() -> ctypes.CDLL:
    with _lib_lock:
        return _runtime_libs.get("cuda") or _load_cuda()


def _load_cuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    U, P = ctypes.c_uint, ctypes.POINTER
    for fn, args in (
            ("cuInit", [U]),
            ("cuDeviceGet", [P(_I), _I]),
            ("cuDeviceGetAttribute", [P(_I), _I, _I]),
            ("cuDevicePrimaryCtxRetain", [P(_P), _I]),
            ("cuCtxSetCurrent", [_P]),
            ("cuModuleLoadData", [P(_P), ctypes.c_char_p]),
            ("cuModuleGetFunction", [P(_P), _P, ctypes.c_char_p]),
            ("cuFuncSetAttribute", [_P, _I, _I]),
            ("cuFuncGetAttribute", [P(_I), _I, _P]),
            ("cuOccupancyMaxActiveBlocksPerMultiprocessor",
             [P(_I), _P, _I, ctypes.c_size_t]),
            ("cuLaunchKernel", [_P, U, U, U, U, U, U, U, _P, _P, _P]),
            ("cuGetErrorName", [_I, P(ctypes.c_char_p)])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = _I
    _cu_check(lib, lib.cuInit(0), "cuInit")
    _runtime_libs["cuda"] = lib
    return lib


def _cu_check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        name = ctypes.c_char_p()
        lib.cuGetErrorName(rc, ctypes.byref(name))
        raise RuntimeError(f"{what} failed: CUresult {rc} "
                           f"({(name.value or b'?').decode()})")


def _context(index: int) -> ctypes.c_void_p:
    """The primary context of card ``index`` (torch's), retained once."""
    ctx = _contexts.get(index)
    if ctx is None:
        cu = _cuda()
        dev, ctx = ctypes.c_int(), ctypes.c_void_p()
        _cu_check(cu, cu.cuDeviceGet(ctypes.byref(dev), index), "cuDeviceGet")
        _cu_check(cu, cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                  "cuDevicePrimaryCtxRetain")
        _contexts[index] = ctx
    return ctx


def _spec_key(source: str, headers: dict[str, bytes]) -> str:
    digest = hashlib.sha256(source.encode())
    for name in SPEC_HEADERS:
        digest.update(name.encode() + b"\0" + headers[name])
    digest.update(" ".join(NVRTC_FLAGS).encode())
    return digest.hexdigest()


def nvrtc_compile(source: str, headers: dict[str, bytes], name: str
                  ) -> tuple[bytes, str]:
    """Kernel ``name``'s ``source`` compiled with NVRTC for ``sm_90a``:
    (cubin, log). The headers go in memory; the log has ptxas' report."""
    lib = _nvrtc()
    C = ctypes.c_char_p
    prog = ctypes.c_void_p()
    names = (C * len(SPEC_HEADERS))(*(h.encode() for h in SPEC_HEADERS))
    texts = (C * len(SPEC_HEADERS))(*(headers[h] for h in SPEC_HEADERS))
    rc = lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                f"{name}.cu".encode(), len(SPEC_HEADERS),
                                texts, names)
    if rc != 0:
        raise RuntimeError(f"nvrtcCreateProgram: "
                           f"{lib.nvrtcGetErrorString(rc).decode()}")
    try:
        opts = (C * len(NVRTC_FLAGS))(*(f.encode() for f in NVRTC_FLAGS))
        rc = lib.nvrtcCompileProgram(prog, len(NVRTC_FLAGS), opts)
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        buf = ctypes.create_string_buffer(size.value + 1)
        lib.nvrtcGetProgramLog(prog, buf)
        log = buf.value.decode(errors="replace")
        if rc != 0:
            raise RuntimeError(f"NVRTC failed on {name} "
                               f"({lib.nvrtcGetErrorString(rc).decode()}):"
                               f"\n{log}\n--- source ---\n{source}")
        if lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)) != 0:
            raise RuntimeError("nvrtcGetCUBINSize failed")
        buf = ctypes.create_string_buffer(size.value)
        if lib.nvrtcGetCUBIN(prog, buf) != 0:
            raise RuntimeError("nvrtcGetCUBIN failed")
        return buf.raw, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


class SpecKernel:
    """One compiled kernel, loaded per card on first launch.

    ``how`` is ``"compiled"`` (NVRTC ran, ``compile_seconds`` long) or
    ``"loaded"`` (the cubin came from the disk cache); ``resources[card]``
    holds what the driver reports of the loaded function."""

    def __init__(self, src, key: str, cubin: bytes, log: str, how: str,
                 compile_seconds: float):
        self.src, self.key, self.cubin, self.log = src, key, cubin, log
        self.how, self.compile_seconds = how, compile_seconds
        self.resources: dict[int, dict] = {}
        self._fns: dict[int, tuple] = {}
        self._blocks: dict[tuple[int, int], int] = {}

    def _function(self, index: int) -> tuple:
        with _spec_lock:
            got = self._fns.get(index)
            if got is not None:
                return got
            with tracing.span("kernel.module"), \
                    tracing.busy(scan_codegen.BUILD_BUSY):
                got = self._fns[index] = self._load(index)
            return got

    def _load(self, index: int) -> tuple:
        """Load the cubin onto card ``index`` (under ``_spec_lock``)."""
        cu, ctx = _cuda(), _context(index)
        _cu_check(cu, cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
        mod, fn = ctypes.c_void_p(), ctypes.c_void_p()
        _cu_check(cu, cu.cuModuleLoadData(ctypes.byref(mod), self.cubin),
                  "cuModuleLoadData")
        _cu_check(cu, cu.cuModuleGetFunction(ctypes.byref(fn), mod,
                                             self.src.entry.encode()),
                  "cuModuleGetFunction")
        smem = self.src.smem_bytes
        _cu_check(cu, cu.cuFuncSetAttribute(fn, _FUNC_MAX_DYNAMIC_SHARED,
                                            smem), "cuFuncSetAttribute")
        _cu_check(cu, cu.cuFuncSetAttribute(fn, _FUNC_CARVEOUT, 100),
                  "cuFuncSetAttribute")
        sms, dev = ctypes.c_int(), ctypes.c_int()
        _cu_check(cu, cu.cuDeviceGet(ctypes.byref(dev), index),
                  "cuDeviceGet")
        _cu_check(cu, cu.cuDeviceGetAttribute(ctypes.byref(sms),
                                              _DEV_SM_COUNT, dev),
                  "cuDeviceGetAttribute")
        attrs = {}
        for name, attr in (("max_threads", _FUNC_MAX_THREADS),
                           ("registers", _FUNC_REGS),
                           ("local_bytes", _FUNC_LOCAL),
                           ("static_shared_bytes", _FUNC_STATIC_SHARED)):
            v = ctypes.c_int()
            _cu_check(cu, cu.cuFuncGetAttribute(ctypes.byref(v), attr, fn),
                      "cuFuncGetAttribute")
            attrs[name] = v.value
        per_sm = self._per_sm(cu, fn, smem)
        self.resources[index] = dict(
            attrs, dynamic_shared_bytes=smem, threads=self.src.threads,
            blocks_per_sm=per_sm, sms=sms.value)
        return ctx, fn, mod, sms.value * per_sm

    def _per_sm(self, cu: ctypes.CDLL, fn, smem: int) -> int:
        per_sm = ctypes.c_int()
        _cu_check(cu, cu.cuOccupancyMaxActiveBlocksPerMultiprocessor(
            ctypes.byref(per_sm), fn, self.src.threads, smem),
            "cuOccupancyMaxActiveBlocksPerMultiprocessor")
        if per_sm.value < 1:
            raise RuntimeError(f"{self.src.entry} does not fit an SM: "
                               f"{smem} B of shared memory")
        return per_sm.value

    def resident(self, index: int, smem: int) -> int:
        """The blocks card ``index`` holds at once, each with ``smem``
        bytes of dynamic shared memory (at most ``src.smem_bytes``),
        cached per card and size: a launch's most useful grid."""
        ctx, fn, _, _ = self._function(index)
        with _spec_lock:
            blocks = self._blocks.get((index, smem))
            if blocks is None:
                cu = _cuda()
                _cu_check(cu, cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
                blocks = self._blocks[index, smem] = (
                    self.resources[index]["sms"] * self._per_sm(cu, fn, smem))
            return blocks

    def launch_with(self, planes, grid: int, smem: int, args) -> None:
        """Launch ``grid`` blocks, each with ``smem`` bytes of dynamic
        shared memory, on ``planes``' card and torch's current stream
        there; ``args`` are the kernel's arguments as ctypes values. (The
        scan kernel's ``launch`` is the same inline: the request path.)"""
        import torch
        with tracing.span("kernel.launch",
                          planes.shape[0] * self.src.row_bytes):
            ctx, fn, _, _ = self._function(planes.device.index)
            stream = torch.cuda.current_stream(planes.device).cuda_stream
            params = (ctypes.c_void_p * len(args))(
                *(ctypes.addressof(a) for a in args))
            cu = _cuda()
            _cu_check(cu, cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
            _cu_check(cu, cu.cuLaunchKernel(
                fn, grid, 1, 1, self.src.threads, 1, 1, smem, stream,
                ctypes.cast(params, ctypes.c_void_p), None),
                f"{self.src.entry} launch")

    def launch(self, planes, counts, regs) -> None:
        """Launch the scan kernel on ``planes``' card and torch's current
        stream there: ``counts`` and ``regs`` are the zeroed outputs
        (``regs`` None without sketches)."""
        import torch
        n = planes.shape[0]
        with tracing.span("kernel.launch", n * self.src.row_bytes):
            ctx, fn, _, cap = self._function(planes.device.index)
            grid = max(1, min(-(-n // scan_codegen.TILE_ROWS), cap))
            stream = torch.cuda.current_stream(planes.device).cuda_stream
            args = (ctypes.c_void_p(planes.data_ptr()), ctypes.c_longlong(n),
                    ctypes.c_void_p(counts.data_ptr()),
                    ctypes.c_void_p(0 if regs is None else regs.data_ptr()))
            params = (ctypes.c_void_p * len(args))(
                *(ctypes.addressof(a) for a in args))
            cu = _cuda()
            _cu_check(cu, cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
            _cu_check(cu, cu.cuLaunchKernel(
                fn, grid, 1, 1, scan_codegen.THREADS, 1, 1,
                self.src.smem_bytes, stream,
                ctypes.cast(params, ctypes.c_void_p), None),
                "scan kernel launch")


def _load_or_compile(src) -> "SpecKernel":
    """The kernel of ``src`` from the disk cache (by a digest of the
    source, the headers and the flags), else from NVRTC."""
    headers = {h: (CSRC / h).read_bytes() for h in SPEC_HEADERS}
    key = _spec_key(src.source, headers)
    path = BUILD_DIR / f"{src.entry}-{key[:16]}.cubin"
    log_path = path.with_suffix(".log")
    if path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return SpecKernel(src, key, path.read_bytes(), log, "loaded", 0.0)
    t = time.perf_counter()
    cubin, log = nvrtc_compile(src.source, headers, src.entry)
    seconds = time.perf_counter() - t
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for f, data in ((log_path, log.encode()), (path, cubin)):
        tmp = f.with_suffix(f"{f.suffix}.{os.getpid()}."
                            f"{threading.get_ident()}.tmp")
        tmp.write_bytes(data)
        os.replace(tmp, f)
    return SpecKernel(src, key, cubin, log, "compiled", seconds)


def spec_kernel(src) -> SpecKernel:
    """The compiled kernel of ``src`` (a ``scan_codegen.KernelSource`` or
    a ``FixedSource``): from the process's cache (by the source's digest),
    else the disk cache, else NVRTC. The lock guards only the caches: a
    compile runs outside it, so other sources compile and launch meanwhile,
    and a thread that asks for one being compiled waits for it."""
    with tracing.span("kernel.get"):
        with _spec_lock:
            kern = _specs.get(src.digest)
            if kern is not None:
                spec_stats["hits"] += 1
                return kern
            fut = _pending.get(src.digest)
            owner = fut is None
            if owner:
                fut = _pending[src.digest] = concurrent.futures.Future()
            else:
                spec_stats["hits"] += 1
        if not owner:
            return fut.result()
        try:
            with tracing.busy(scan_codegen.BUILD_BUSY):
                kern = _load_or_compile(src)
        except BaseException as e:
            with _spec_lock:
                del _pending[src.digest]
            fut.set_exception(e)
            raise
        with _spec_lock:
            spec_stats[kern.how] += 1
            _specs[src.digest] = kern
            del _pending[src.digest]
        fut.set_result(kern)
        return kern


def scan_source(program, n_counters: int, sketch_specs, p):
    """The generated source (cached) of one plan's scan kernel."""
    with tracing.span("kernel.source"):
        return scan_codegen.generate_cached(
            tuple(map(tuple, program)), n_counters,
            tuple((name, tuple(cols)) for name, cols in sketch_specs),
            p if sketch_specs else None)


def compile_scans(srcs) -> list[SpecKernel]:
    """``spec_kernel`` of several sources at once, one thread each: NVRTC
    releases the GIL, so a pipeline's plans compile in parallel before its
    first launch instead of one after another at each plan's first."""
    srcs = list(srcs)
    if len(srcs) < 2:
        return [spec_kernel(s) for s in srcs]
    workers = min(len(srcs), os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(spec_kernel, srcs))


def launch_scan(planes, program, n_counters: int, sketch_specs, p,
                counts, regs) -> SpecKernel:
    """Generate (cached), compile (cached) and launch the scan kernel of
    one plan on ``planes``; returns the kernel."""
    kern = spec_kernel(scan_source(program, n_counters, sketch_specs, p))
    kern.launch(planes, counts, regs)
    return kern
