"""The port's kernel builder (``kernels/build.py``) with a stand-in nvcc.

A library is built once; its nvcc log (ptxas registers and spills) is
kept beside it and read back when the library is reused, so
``chip_smoke.py``'s spill check sees a cached build's ptxas lines too.
A library's path hashes its source and the shared ``csrc/*.cuh``
headers, so an edited header never loads a stale library.
"""

import chip_smoke
from learningorchestra_tpu_torch.kernels import build

_ENTRY = ("_ZN12_GLOBAL__N_122flash_bwd_dq_tc_kernelILi64ELi64ELb0EEEv"
          "NS_6ParamsE")
PTXAS = f"""ptxas info    : Compiling entry function '{_ENTRY}' for 'sm_90a'
ptxas info    : Function properties for {_ENTRY}
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
"""


def test_cached_library_keeps_its_ptxas_log(tmp_path, monkeypatch):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    # Writes the -o target and prints the canned ptxas report.
    nvcc.write_text(
        "#!/bin/sh\n"
        'while [ $# -gt 0 ]; do [ "$1" = -o ] && out=$2; shift; done\n'
        ': > "$out"\n'
        f"cat <<'EOF'\n{PTXAS}EOF\n"
    )
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "build_log", {})

    assert build.build(("flash_bwd",))["flash_bwd"] > 0.0
    assert build.library_path("flash_bwd").is_file()
    assert chip_smoke.ptxas_report(build.build_log["flash_bwd"]) == [
        ("flash_bwd_dq_tc_kernel<64,64,false>", 168, 8, 4)
    ]

    build.build_log.clear()  # a later process: the library is reused
    assert build.build(("flash_bwd",)) == {"flash_bwd": 0.0}
    assert build.build_log["flash_bwd"] == PTXAS


def test_header_edit_changes_the_library_path(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "flash_fwd.cu").write_text('#include "tc_common.cuh"\n')
    header = csrc / "tc_common.cuh"
    header.write_text("// helpers, first version\n")
    monkeypatch.setattr(build, "CSRC", csrc)

    first = build.library_path("flash_fwd")
    assert build.library_path("flash_fwd") == first  # stable
    header.write_text("// helpers, edited\n")
    assert build.library_path("flash_fwd") != first
