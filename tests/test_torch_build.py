"""The port's kernel build cache (``yolo_v3_tpu_torch/ops/_build.py``): a
library is rebuilt when its source or a header it includes changes.  Runs on
the CPU: only the digest is computed, nothing is compiled."""

from yolo_v3_tpu_torch.ops import _build


def test_digest_follows_included_headers(tmp_path):
    (tmp_path / "inc").mkdir()
    main = tmp_path / "k.cu"
    main.write_text('#include <cuda.h>\n#include "inc/a.cuh"\nint k;\n')
    (tmp_path / "inc" / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "inc" / "b.cuh").write_text("// b\n")
    (tmp_path / "unrelated.cuh").write_text("// not included\n")
    first = _build.source_digest(main)
    assert _build.source_digest(main) == first
    (tmp_path / "unrelated.cuh").write_text("// edited\n")
    assert _build.source_digest(main) == first
    (tmp_path / "inc" / "b.cuh").write_text("// b, edited\n")     # included by a header
    second = _build.source_digest(main)
    assert second != first
    main.write_text('#include <cuda.h>\n#include "inc/a.cuh"\nint k2;\n')
    assert _build.source_digest(main) not in (first, second)


def test_wgmma_sources_share_the_sm90_header():
    """The three wgmma kernels (the int8 entry since its redesign) include
    csrc/sm90.cuh, so an edit to it rebuilds all three libraries."""
    for name, includes in (("conv_p2d", True), ("fused_res_block", True),
                           ("fused_entry", True)):
        text = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert ('#include "sm90.cuh"' in text) == includes, name
