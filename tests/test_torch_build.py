"""The port's nvcc build helper, on the CPU: a stand-in ``nvcc`` script
takes the real one's place, so no compiler or card is needed."""
import stat

import pytest

from repro_torch.kernels import build as kbuild


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc that writes its ``-o`` file, prints a ptxas line and
    counts its runs; sources under tmp_path/csrc, libraries under build/."""
    runs = tmp_path / "runs"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\n'
                    f'echo run >> "{runs}"\n'
                    'case "$*" in *fail.cu*) echo "error: no" >&2; exit 1;; esac\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo lib > "$2"\n'
                    'echo "ptxas info    : Used 39 registers, used 1 barriers"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(kbuild, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kbuild, "CSRC", csrc)
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build")
    return csrc, lambda: len(runs.read_text().splitlines()) if runs.exists() else 0


def test_build_keeps_the_ptxas_report_and_rebuilds_on_an_edit(fake_nvcc):
    csrc, runs = fake_nvcc
    src = csrc / "k.cu"
    src.write_text("// kernel\n")
    lib, report = kbuild.build(src)
    assert lib.exists() and lib.parent == kbuild.BUILD_DIR and lib.suffix == ".so"
    assert "Used 39 registers" in report and runs() == 1
    assert kbuild.build(src) == (lib, report) and runs() == 1   # built: no nvcc
    (csrc / "shared.cuh").write_text("// header\n")             # a header edit
    lib2, _ = kbuild.build(src)
    src.write_text("// kernel, edited\n")                        # a source edit
    lib3, _ = kbuild.build(src)
    assert len({lib, lib2, lib3}) == 3 and runs() == 3


def test_build_raises_with_nvcc_output(fake_nvcc):
    csrc, runs = fake_nvcc
    src = csrc / "fail.cu"
    src.write_text("// does not compile\n")
    with pytest.raises(RuntimeError, match="nvcc failed on fail.cu:\n.*error: no"):
        kbuild.build(src)
    assert not list(kbuild.BUILD_DIR.glob("*.so")) and runs() == 1
