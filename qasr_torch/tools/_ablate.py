"""Shared machinery of the ablations (``ablate_qgemm``, ``ablate_qconv``,
``ablate_scan``): a version of the kernel library built by ``nvcc`` from
copies of ``csrc``'s headers and of some sources, patched, under
``qasr_torch/_build/<tool>/<i>/``; its registers; CUDA-event times; and the
run of every version in a process of its own (kernels that use TMA, loaded
beside another build in one process, refused to launch), in turns, first
to last, then back.
"""

from __future__ import annotations

import ctypes
import glob
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from qasr_torch.ops.kernels import _build

#: bf16 parity limits of the whole versions (chip_smoke.py's TOL_BF16)
TOL_BF16 = {"rel_norm": 1e-2, "max_rel": 5e-2}


def patched(sources: tuple[str, ...], edits: list[tuple[str, str, str]]) -> dict[str, str]:
    """The texts of every ``csrc`` header and of ``sources``, with ``edits``
    ((file, old, new)) made; raises when a file no longer has an old
    string."""
    files = sorted(os.path.basename(h) for h in glob.glob(os.path.join(_build.CSRC, "*.cuh")))
    texts = {}
    for name in [*files, *sources]:
        with open(os.path.join(_build.CSRC, name)) as f:
            texts[name] = f.read()
    for name, old, new in edits:
        if old not in texts[name]:
            raise RuntimeError(f"{name} no longer has {old!r}")
        texts[name] = texts[name].replace(old, new)
    return texts


def build_version(tool: str, i: int, sources: tuple[str, ...],
                  edits: list[tuple[str, str, str]]) -> str:
    """``sources`` built against copies of every ``csrc`` header, with
    ``edits`` made to the copies (:func:`patched`); returns the library's
    path, or "" when it does not build."""
    texts = patched(sources, edits)
    out = os.path.join(_build.BUILD_DIR, tool, str(i))
    os.makedirs(out, exist_ok=True)
    for name, text in texts.items():  # side by side, so that each #include finds the copy
        with open(os.path.join(out, name), "w") as f:
            f.write(text)
    lib = os.path.join(out, f"lib{tool}.so")
    try:
        log = _build.compile_library([os.path.join(out, s) for s in sources], lib)
    except RuntimeError as e:  # a version that does not build is reported and left out
        print(f"{tool} version {i} does not build: " + "\n".join(
            line for line in str(e).splitlines() if "error" in line)[:3000], flush=True)
        return ""
    with open(os.path.join(out, "build.log"), "w") as f:
        f.write(log)
    return lib


def open_version(path: str, entries: tuple[str, ...]) -> ctypes.CDLL:
    """A version's library with ``entries`` (and the error strings)
    declared."""
    lib = ctypes.CDLL(path)
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes = _build._ENTRIES[name]
        fn.restype = ctypes.c_int
    lib.qasr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.qasr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def registers(path: str, kernel_match: str) -> list[str]:
    """ptxas's registers and spills of the kernels whose mangled name holds
    ``kernel_match``, in a version's build."""
    with open(os.path.join(os.path.dirname(path), "build.log")) as f:
        log = f.read()
    out, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
        if kernel and kernel_match in kernel and ("Used" in line or "spill" in line):
            out.append(f"{kernel}: {line.strip()}")
    return out


def time_ms(fn, n: int) -> float:
    """ms a call of ``fn`` over ``n`` calls after three, CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def check_parity(what: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    """Raise when ``got`` is beyond TOL_BF16 of ``ref``."""
    got, ref = got.float(), ref.float()
    rel = ((got - ref).norm() / ref.norm()).item()
    mx = ((got - ref).abs().max() / ref.abs().max()).item()
    if not (rel <= TOL_BF16["rel_norm"] and mx <= TOL_BF16["max_rel"]):
        raise RuntimeError(f"{what}: rel_norm {rel:.3e} max_rel {mx:.3e} exceed {TOL_BF16}")


def main(module: str, tool: str, versions: dict, sources: tuple[str, ...], kernel_match: str,
         names: list[str], run_args: tuple[str, ...] = ()) -> None:
    """Build every version named (all of ``versions`` when none is; all
    nvcc runs at once), print their registers, then run each as ``python3
    -m module --run NAME PATH *run_args`` in turns, first to last and
    back."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{tool} needs a CUDA device")
    names = names or list(versions)
    unknown = [n for n in names if n not in versions]
    if unknown:
        raise ValueError(f"unknown versions {unknown}; known: {list(versions)}")
    print(torch.cuda.get_device_name(0), flush=True)
    with ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(
            lambda i: build_version(tool, i, sources, versions[names[i]][0]), range(len(names)))))
    names = [n for n in names if paths[n]]
    for name in names:
        print(f"{name}: " + "; ".join(registers(paths[name], kernel_match)), flush=True)
    for name in names + names[::-1]:
        proc = subprocess.run([sys.executable, "-m", module, "--run", name, paths[name],
                               *run_args], capture_output=True, text=True)
        print(proc.stdout.strip() or f"{name}: rc {proc.returncode} {proc.stderr[-800:]}",
              flush=True)
