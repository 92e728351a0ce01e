"""K3's register kernel (``regs_kernel`` in csrc/jacobi_fused.cu) run on
the CPU: g++ compiles the CUDA source against stand-in headers that run
each CUDA thread as a std::thread (tests/_torch_cuda_emu.h), and
tests/_torch_regs_emu.cpp holds one instance's result against a plain loop
of the same arithmetic, bit for bit in fp32.  This checks the kernel's
indexing (its patches, the edges it exchanges through shared memory and by
shuffles, the pinned shell and the cells off the grid) where no card is;
the card tests (test_torch_cuda.py) hold the built kernel itself against
``jacobi2d_fused_plain``.
"""
import re
import shutil
import subprocess
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
SOURCE = TESTS.parent / "src" / "repro_torch" / "csrc" / "jacobi_fused.cu"
STAR, BOX = 0x0AA, 0x1FF


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulation")
    d = tmp_path_factory.mktemp("regs_emu")
    for name in ("cuda_runtime.h", "cuda_bf16.h"):
        shutil.copy(TESTS / "_torch_cuda_emu.h", d / name)
    for header in SOURCE.parent.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    # The launch syntax and inline PTX have no C++ form; a named namespace
    # lets the harness define the kernels' dynamic shared memory.
    src = SOURCE.read_text()
    src = re.sub(r"<<<[^;]*?>>>", "", src)
    src = re.sub(r"asm volatile\([^;]*\);", "", src, flags=re.S)
    assert src.count("namespace {") == 1
    src = src.replace("namespace {", "namespace kernels {")
    src = src.replace("}  // namespace\n",
                      "}  // namespace\nusing namespace kernels;\n", 1)
    (d / "jacobi_fused.cpp").write_text(src)
    exe = d / "regs_emu"
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
         "-Wno-attributes", f"-I{d}", '-DEMU_SOURCE="jacobi_fused.cpp"',
         str(TESTS / "_torch_regs_emu.cpp"), "-o", str(exe)],
        capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-4000:]
    return exe


# (mask, rows a thread, fields, H, W, steps, bc): the 5-point star and the
# 3x3 box at each KC, with and without fields and a bc, on grids of one
# and several warps a row of threads, ragged in both directions.
CASES = [
    (STAR, 4, 0, 64, 64, 5, 1), (STAR, 4, 0, 33, 57, 7, 0),
    (STAR, 8, 1, 33, 57, 6, 1), (STAR, 16, 0, 64, 128, 6, 1),
    (STAR, 4, 1, 9, 200, 4, 1), (STAR, 8, 0, 1, 1, 3, 0),
    (STAR, 16, 1, 40, 130, 3, 0), (STAR, 8, 0, 9, 10, 3, 1),
    (BOX, 4, 0, 33, 57, 5, 0), (BOX, 4, 1, 64, 64, 4, 1),
    (BOX, 8, 0, 19, 200, 3, 0), (BOX, 16, 1, 40, 130, 4, 1),
    (BOX, 16, 0, 30, 64, 5, 1), (BOX, 8, 1, 2, 70, 2, 1),
]


@pytest.mark.parametrize("mask,kc,fields,H,W,steps,bc", CASES)
def test_register_kernel_emulated_matches_plain_loop(
        emulator, mask, kc, fields, H, W, steps, bc):
    run = subprocess.run(
        [str(emulator), hex(mask), str(kc), str(fields), str(H), str(W),
         str(steps), str(bc)], capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert run.stdout.strip() == "0 cells differ"
