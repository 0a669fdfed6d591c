"""The port's CUDA build cache (``repro_torch.kernels.build``), on the CPU:
a library is named by a digest of its source, every header it includes and
the flags, so an edited source or shared header never loads a stale build.
Nothing here compiles (there is no ``nvcc`` on the CPU)."""

import shutil

from repro_torch.kernels import build


def _copy(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    return csrc


def test_digest_follows_an_included_headers_bytes(tmp_path):
    csrc = _copy(tmp_path)
    before = {n: build._target(n, csrc) for n in build.SOURCES}
    assert before == {n: build._target(n) for n in build.SOURCES}
    header = csrc / "hopper_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: build._target(n, csrc) for n in build.SOURCES}
    users = {n for n in build.SOURCES
             if csrc / "hopper_common.cuh" in build._sources(csrc / f"{n}.cu", {})}
    assert users == {"tugemm_fused", "tugemm_int8", "tugemm_packed", "temporal_unary",
                     "unary_stats"}
    for n in build.SOURCES:
        assert (after[n] != before[n]) == (n in users), n


def test_digest_follows_headers_included_by_headers(tmp_path):
    csrc = _copy(tmp_path)
    before = build._target("tugemm_int8", csrc)
    # tugemm_int8.cu includes tugemm_mainloop.cuh, which includes hopper_common.cuh
    assert "hopper_common.cuh" not in (csrc / "tugemm_int8.cu").read_text()
    header = csrc / "hopper_common.cuh"
    header.write_bytes(header.read_bytes().replace(b"namespace hopper", b"namespace  hopper"))
    assert build._target("tugemm_int8", csrc) != before


def test_digest_follows_the_source_and_ignores_unincluded_files(tmp_path):
    csrc = _copy(tmp_path)
    before = build._target("flash_paged", csrc)
    (csrc / "unused.cuh").write_text("// not included by anything\n")
    assert build._target("flash_paged", csrc) == before
    src = csrc / "flash_paged.cu"
    src.write_bytes(src.read_bytes() + b" ")
    assert build._target("flash_paged", csrc) != before


def test_packed_gemm_digest_follows_the_mainloop_and_its_headers(tmp_path):
    """tugemm_packed.cu is a launcher of tugemm_mainloop.cuh, which includes
    hopper_common.cuh and launch_attrs.cuh: an edit to any of them renames
    its library."""
    csrc = _copy(tmp_path)
    assert "hopper_common.cuh" not in (csrc / "tugemm_packed.cu").read_text()
    for header in ("tugemm_mainloop.cuh", "hopper_common.cuh", "launch_attrs.cuh"):
        before = build._target("tugemm_packed", csrc)
        path = csrc / header
        path.write_bytes(path.read_bytes() + b"\n// edited\n")
        assert build._target("tugemm_packed", csrc) != before, header


def test_launch_attribute_header_is_hashed_into_its_users(tmp_path):
    """launch_attrs.cuh (per-device function attributes) is included by the
    mainloop's three GEMMs and by flash_paged.cu, and by nothing else."""
    csrc = _copy(tmp_path)
    header = csrc / "launch_attrs.cuh"
    users = {n for n in build.SOURCES if header in build._sources(csrc / f"{n}.cu", {})}
    assert users == {"tugemm_fused", "tugemm_int8", "tugemm_packed", "flash_paged"}
    before = {n: build._target(n, csrc) for n in build.SOURCES}
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    for n in build.SOURCES:
        assert (build._target(n, csrc) != before[n]) == (n in users), n
