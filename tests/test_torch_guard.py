"""Guards of the PyTorch port's boundaries: it imports neither jax nor the
JAX package, it never falls back to the CPU when nobody asked for it,
and its kernels build for Hopper (sm_90a) from sources in the repo."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "triton_dist_tpu_torch"
PORT_FILES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                              ROOT / "step_times.py"]


def _module_names():
    return ["triton_dist_tpu_torch." + ".".join(
        p.relative_to(PACKAGE).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in sorted(PACKAGE.rglob("*.py"))]


def test_port_modules_import_without_jax():
    mods = _module_names()
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'triton_dist_tpu' or "
              "m.startswith('triton_dist_tpu.'))\n"
              "assert not bad, bad\nprint(len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 15


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_jax_package(path):
    for name in _imports(path):
        top = name.split(".")[0]
        # Whole-name match: triton_dist_tpu_torch starts with
        # triton_dist_tpu but is the port itself.
        assert top not in ("jax", "jaxlib", "triton_dist_tpu"), (path, name)


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    from triton_dist_tpu_torch import default_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    assert default_device("cpu") == torch.device("cpu")


def test_dense_and_engine_need_an_explicit_cpu(no_cuda):
    from triton_dist_tpu_torch.models import DenseLLM, Engine, ModelConfig
    cfg = ModelConfig(hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=1, head_dim=8, vocab_size=32,
                      max_position_embeddings=16, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseLLM(cfg)
    model = DenseLLM(cfg, device="cpu")
    assert Engine(model, batch=1, max_seq=8).device == torch.device("cpu")


def test_gemm_ar_on_a_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """Without a card, a CUDA-typed call reaches the kernel build (and
    fails there) instead of quietly computing on the CPU."""
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as ops

    class FakeCuda:
        type = "cuda"

    class FakeTensor:
        device = FakeCuda()
        dtype = torch.bfloat16
        shape = (2, 4)

        def dim(self):
            return 2

        def is_contiguous(self):
            return True

    a, b = FakeTensor(), FakeTensor()
    b.shape = (4, 8)
    monkeypatch.setattr(ops, "gemm_ar_reference", lambda *_: pytest.fail(
        "CUDA call took the plain version"))

    def refuse(name):
        raise RuntimeError(f"no build of {name}")
    monkeypatch.setattr(_build, "load", refuse)
    with pytest.raises(RuntimeError, match="no build of gemm_ar"):
        ops.gemm_ar(a, b)


def test_flash_decode_on_cuda_tensors_never_takes_the_plain_path(
        monkeypatch):
    """Without a card, CUDA-typed flash-decode calls (each entry point
    and each kernel wrapper) reach the kernel build and fail there
    instead of computing the plain version on the CPU."""
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import flash_decode as fd

    def fake(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device="meta")

    class CudaView:
        """A meta tensor that reports the CUDA device."""

        def __init__(self, t):
            self._t = t
            self.device = torch.device("cuda", 0)
            self.dtype, self.shape = t.dtype, t.shape

        def dim(self):
            return self._t.dim()

        def is_contiguous(self):
            return True

        def element_size(self):
            return self._t.element_size()

        def __getitem__(self, i):
            return CudaView(self._t[i])

    q = CudaView(fake((2, 8, 16)))
    cache = CudaView(fake((2, 32, 2, 16)))
    pool = CudaView(fake((9, 4, 2, 16)))
    table = CudaView(fake((1, 2, 8), torch.int32))
    for name in ("flash_decode_reference", "flash_decode_paged_reference",
                 "flash_decode_partials_reference",
                 "flash_decode_combine_reference"):
        monkeypatch.setattr(fd, name, lambda *_, **__: pytest.fail(
            "CUDA call took the plain version"))

    def refuse(name):
        raise RuntimeError(f"no build of {name}")
    monkeypatch.setattr(_build, "load", refuse)
    calls = [
        lambda: fd.gqa_fwd_batch_decode(
            q, cache, cache, 3, fd.FlashDecodeContext(variant="einsum")),
        lambda: fd.gqa_fwd_batch_decode(
            q, cache, cache, 3, fd.FlashDecodeContext(variant="tiled")),
        lambda: fd.gqa_fwd_batch_decode_paged(q, pool, pool, table, 3),
        lambda: fd.flash_decode_single(q, cache, cache, 3),
        lambda: fd.flash_decode_partial(q, cache, cache, 3, 64, 1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no build of flash_decode"):
            call()


def test_ag_gemm_entry_points_on_cuda_tensors_never_take_the_plain_path(
        monkeypatch):
    """Without a card, CUDA-typed calls of ag_gemm_multi, ag_gemm,
    ag_swiglu (both sides of the fusion rule) and gemm_rs (both plans)
    reach a kernel build and fail there instead of computing a plain
    version on the CPU."""
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as rs

    class CudaView:
        """A meta tensor that reports the CUDA device."""

        def __init__(self, *shape):
            self._t = torch.zeros(shape, dtype=torch.bfloat16, device="meta")
            self.device = torch.device("cuda", 0)
            self.dtype, self.shape = self._t.dtype, self._t.shape

        def dim(self):
            return self._t.dim()

        def is_contiguous(self):
            return True

        def element_size(self):
            return self._t.element_size()

    for name in ("ag_gemm_multi_reference", "ag_swiglu_reference"):
        monkeypatch.setattr(ag, name, lambda *_, **__: pytest.fail(
            "CUDA call took the plain version"))
    monkeypatch.setattr(rs, "gemm_rs_reference", lambda *_: pytest.fail(
        "CUDA call took the plain version"))

    def refuse(name):
        raise RuntimeError(f"no build of {name}")
    monkeypatch.setattr(_build, "load", refuse)
    x512, x4 = CudaView(512, 64), CudaView(4, 64)
    w, wd = CudaView(64, 256), CudaView(256, 64)
    calls = [
        ("ag_gemm", lambda: ag.ag_gemm_multi(x512, [w, w, w])),
        ("ag_gemm", lambda: ag.ag_gemm(x4, w)),
        ("ag_gemm", lambda: ag.ag_swiglu(x512, w, w)),        # fused
        ("ag_gemm", lambda: ag.ag_swiglu(x4, w, w)),          # composed
        ("ag_gemm", lambda: rs.gemm_rs(CudaView(512, 256), wd)),
        ("gemm_ar", lambda: rs.gemm_rs(CudaView(4, 256), wd)),
    ]
    assert ag.swiglu_fuses(512, 64, 256, 2)
    assert not ag.swiglu_fuses(4, 64, 256, 2)
    for lib, call in calls:
        with pytest.raises(RuntimeError, match=f"no build of {lib}"):
            call()


def test_ring_entry_points_on_cuda_tensors_never_take_the_plain_path(
        monkeypatch):
    """Without a card, CUDA-typed calls of ag_gemm_multi, ag_gemm,
    ag_swiglu (fused and composed), gemm_rs and gemm_ar over a world-4
    rank group reach the ring kernels' builds and fail there instead of
    computing a plain ring version on the CPU."""
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as rs
    from triton_dist_tpu_torch.runtime.dist import create_rank_group

    class CudaView:
        """A meta tensor that reports the CUDA device."""

        def __init__(self, *shape):
            self._t = torch.zeros(shape, dtype=torch.bfloat16, device="meta")
            self.device = torch.device("cuda", 0)
            self.dtype, self.shape = self._t.dtype, self._t.shape

        def dim(self):
            return self._t.dim()

        def is_contiguous(self):
            return True

        def element_size(self):
            return self._t.element_size()

    for name in ("ag_gemm_multi_ring_reference", "ag_swiglu_ring_reference",
                 "ag_gemm_multi_reference", "ag_swiglu_reference"):
        monkeypatch.setattr(ag, name, lambda *_, **__: pytest.fail(
            "CUDA call took the plain version"))
    for name in ("gemm_rs_ring_reference", "gemm_ar_ring_reference",
                 "gemm_rs_reference", "_psum_of_products"):
        monkeypatch.setattr(rs, name, lambda *_, **__: pytest.fail(
            "CUDA call took the plain version"))

    def refuse(name):
        raise RuntimeError(f"no build of {name}")
    monkeypatch.setattr(_build, "load", refuse)
    group = create_rank_group(4, device="meta")
    x512, x4 = CudaView(512, 64), CudaView(4, 64)
    w, wd = CudaView(64, 512), CudaView(512, 64)
    calls = [
        ("ag_gemm_ring", lambda: ag.ag_gemm_multi(x512, [w, w, w], group)),
        ("ag_gemm_ring", lambda: ag.ag_gemm(x4, w, group)),
        ("ag_gemm_ring", lambda: ag.ag_swiglu(x512, w, w, group=group)),
        ("ag_gemm_ring", lambda: ag.ag_swiglu(x4, w, w, group=group)),
        ("gemm_rs_ring", lambda: rs.gemm_rs(CudaView(512, 512), wd, group)),
        ("gemm_rs_ring", lambda: rs.gemm_ar(CudaView(3, 512), wd, group)),
    ]
    assert ag.swiglu_fuses(128, 64, 128, 2)
    assert not ag.swiglu_fuses(1, 64, 128, 2)
    for lib, call in calls:
        with pytest.raises(RuntimeError, match=f"no build of {lib}"):
            call()


def test_ring_sources_target_sm90a_through_cooperative_launches():
    from triton_dist_tpu_torch.ops import _build
    for name, entries, kernels in (
            ("ag_gemm_ring", ("tdt_ag_ring_grid", "tdt_ag_ring_sizes",
                              "tdt_ag_ring"),
             ("_ag_gemm_kernel", "_ag_gemm_hbm_nb_kernel",
              "_ag_gemm_hbm_kernel", "_ag_swiglu_hbm_kernel")),
            ("gemm_rs_ring", ("tdt_rs_ring_grid", "tdt_rs_ring_tiles",
                              "tdt_rs_ring"),
             ("_gemm_rs_kernel", "_gemm_rs_hbm_nb_kernel",
              "_gemm_rs_hbm_kernel"))):
        src = _build.SOURCES[name]
        assert src.is_file() and src.is_relative_to(PACKAGE)
        cmd = _build.nvcc_command(src, pathlib.Path("/tmp/out.so"))
        assert "arch=compute_90a,code=sm_90a" in cmd and str(src) in cmd
        text = src.read_text()
        assert 'extern "C"' in text and '#include "shmem.cuh"' in text
        assert '#include "tiles.cuh"' in text
        assert "cudaLaunchCooperativeKernel" in text
        for entry in entries:
            assert entry in text
        for kernel in kernels:                # the TPU kernels it replaces
            assert kernel in text
        for atomic in ("atomicAdd", "atomicMax", "atomicCAS", "atomicExch"):
            assert atomic not in text         # fixed-order sums only
        for library in ("cublas", "cutlass::gemm::device", "torch/"):
            assert library not in text.lower()


def test_ag_gemm_source_targets_sm90a_without_atomics():
    from triton_dist_tpu_torch.ops import _build
    src = _build.SOURCES["ag_gemm"]
    assert src.is_file() and src.is_relative_to(PACKAGE)
    cmd = _build.nvcc_command(src, pathlib.Path("/tmp/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(src) in cmd
    text = src.read_text()
    assert 'extern "C"' in text and '#include "tiles.cuh"' in text
    for entry in ("tdt_ag_gemm_plan", "tdt_ag_gemm", "tdt_ag_swiglu"):
        assert entry in text
    # The note at the top names the TPU kernels it replaces.
    for kernel in ("_ag_gemm_hbm_nb_kernel", "_ag_swiglu_hbm_kernel",
                   "_gemm_rs_hbm_kernel"):
        assert kernel in text
    headers = [_build.CSRC_DIR / n for n in ("gemm_common.cuh", "tiles.cuh")]
    assert all(h in _build.HEADERS for h in headers)
    for path in (src, *headers):
        body = path.read_text()
        for atomic in ("atomicAdd", "atomicMax", "atomicCAS", "atomicExch"):
            assert atomic not in body           # fixed-order sums only
        for library in ("cublas", "cutlass::gemm::device", "torch/"):
            assert library not in body.lower()  # no library product


def test_header_edits_change_every_build_name(monkeypatch, tmp_path):
    """A build's name hashes the csrc headers too, so an edited header
    never loads a stale library."""
    from triton_dist_tpu_torch.ops import _build
    before = {n: _build._library_path(n) for n in _build.SOURCES}
    header = tmp_path / "edited.cuh"
    header.write_text("// edited\n")
    monkeypatch.setattr(_build, "HEADERS", _build.HEADERS + [header])
    after = {n: _build._library_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)


def test_flash_decode_source_targets_sm90a_without_atomics():
    from triton_dist_tpu_torch.ops import _build
    src = _build.SOURCES["flash_decode"]
    assert src.is_file() and src.is_relative_to(PACKAGE)
    cmd = _build.nvcc_command(src, pathlib.Path("/tmp/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(src) in cmd
    text = src.read_text()
    assert 'extern "C"' in text
    for entry in ("tdt_flash_decode_plan", "tdt_flash_decode_partial",
                  "tdt_flash_decode_combine", "tdt_flash_decode_single"):
        assert entry in text
    # Fixed-order sums only: the one atomic is the fused merge's arrival
    # ticket, which orders nothing but the choice of the merging block.
    assert re.findall(r"\batomic\w+\(", text) == ["atomicAdd("]
    assert "atomicAdd(p.tickets + bh, 1)" in text


def test_build_command_targets_sm90a_and_sources_exist():
    from triton_dist_tpu_torch.ops import _build
    assert _build.SOURCES and all(p.is_file() and p.is_relative_to(PACKAGE)
                                  for p in _build.SOURCES.values())
    src = _build.SOURCES["gemm_ar"]
    cmd = _build.nvcc_command(src, pathlib.Path("/tmp/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and str(src) in cmd
    text = src.read_text()
    assert 'extern "C"' in text and "tdt_gemm_ar" in text
    assert "atomicAdd" not in text          # deterministic split-K
    assert _build.BUILD_DIR.relative_to(PACKAGE)


def test_build_dir_and_sources_are_set_up_for_git_and_packaging():
    ignore = (ROOT / ".gitignore").read_text().splitlines()
    assert "/triton_dist_tpu_torch/_kernels/" in ignore
    assert '"csrc/*.cu"' in (ROOT / "pyproject.toml").read_text()
    assert '"csrc/*.cuh"' in (ROOT / "pyproject.toml").read_text()
    from triton_dist_tpu_torch.ops import _build
    assert set(_build.SOURCES) == {"gemm_ar", "flash_decode", "ag_gemm",
                                   "group_gemm", "moe_rs", "allgather",
                                   "sp_attention", "all_to_all",
                                   "ag_gemm_ring", "gemm_rs_ring",
                                   "ag_group_gemm", "moe_rs_ring",
                                   "reduce_world", "p2p"}
    assert set(_build.SOURCES.values()) == set(_build.CSRC_DIR.glob("*.cu"))


def test_moe_entry_points_on_cuda_tensors_never_take_the_plain_path(
        monkeypatch):
    """Without a card, CUDA-typed calls of the grouped GEMM (both
    epilogues, the FFN, ag_group_gemm), the MoE-reduce (every impl) and
    the all-gather reach a kernel build and fail there instead of
    computing a plain version on the CPU."""
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs

    def on_cuda(t):
        """A CPU tensor that reports the CUDA device."""
        class CudaView(torch.Tensor):
            @property
            def device(self):
                return torch.device("cuda", 0)
        return t.as_subclass(CudaView)

    for mod, name in ((gg, "grouped_matmul_reference"),
                      (gg, "grouped_swiglu_reference"),
                      (mrs, "moe_reduce_rs_reference"),
                      (ag, "all_gather_reference")):
        monkeypatch.setattr(mod, name, lambda *_, **__: pytest.fail(
            "CUDA call took the plain version"))

    def refuse(name):
        raise RuntimeError(f"no build of {name}")
    monkeypatch.setattr(_build, "load", refuse)
    x = on_cuda(torch.zeros(4, 8, dtype=torch.bfloat16))
    w = on_cuda(torch.zeros(3, 8, 16, dtype=torch.bfloat16))
    wd = on_cuda(torch.zeros(3, 16, 8, dtype=torch.bfloat16))
    ids = on_cuda(torch.zeros(8, dtype=torch.int32))
    wts = on_cuda(torch.ones(4, 2))
    ctx = mrs.create_moe_rs_context(num_experts=3, topk=2)
    calls = [
        ("group_gemm", lambda: gg.grouped_matmul(x, w, ids, 3, topk=2)),
        ("group_gemm", lambda: gg.grouped_matmul_multi(x, [w, w], ids, 3,
                                                       topk=2)),
        ("group_gemm", lambda: gg.grouped_swiglu(x, w, w, ids, 3, topk=2)),
        ("group_gemm", lambda: gg.grouped_expert_ffn(x, w, w, wd, ids, 3,
                                                     topk=2)),
        ("group_gemm", lambda: gg.ag_group_gemm(x, w, ids[:4], 3,
                                                impl="fused")),
        ("allgather", lambda: ag.all_gather(x)),
    ] + [("moe_rs", lambda impl=impl: mrs.moe_reduce_rs(
        on_cuda(torch.zeros(8, 16, dtype=torch.bfloat16)), wd, ids, wts,
        ctx, impl=impl)) for impl in ("ring", "xla", "fused")]
    for lib, call in calls:
        with pytest.raises(RuntimeError, match=f"no build of {lib}"):
            call()


@pytest.mark.parametrize("name,kernels", [
    ("group_gemm", ("_ag_group_gemm_kernel",)),
    ("moe_rs", ("_moe_rs_fused_kernel",)),
    ("allgather", ("_full_mesh_push_kernel", "_ring_ag_kernel"))])
def test_moe_sources_target_sm90a_without_atomics(name, kernels):
    from triton_dist_tpu_torch.ops import _build
    src = _build.SOURCES[name]
    assert src.is_file() and src.is_relative_to(PACKAGE)
    cmd = _build.nvcc_command(src, pathlib.Path("/tmp/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(src) in cmd
    text = src.read_text()
    assert 'extern "C"' in text and "tdt_error_string" in text
    for kernel in kernels:                  # the note names what it replaces
        assert kernel in text
    bodies = [text]
    if name != "allgather":
        assert '#include "group_gemm.cuh"' in text
        bodies.append((_build.CSRC_DIR / "group_gemm.cuh").read_text())
    for body in bodies:
        for atomic in ("atomicAdd", "atomicMax", "atomicCAS", "atomicExch"):
            assert atomic not in body           # fixed-order sums only
        for library in ("cublas", "cutlass::gemm::device", "torch/"):
            assert library not in body.lower()  # no library product


def test_sp_attention_and_collectives_on_cuda_tensors_never_take_the_plain_path(
        monkeypatch):
    """Without a card, CUDA-typed calls of the fused SP attention (the
    functional entry, the fused entry, the layer), of ag_pallas (its
    all-gather), of the SP decode layer and of the world = 1 collectives
    (every method) reach a kernel build and fail there instead of
    computing a plain version on the CPU."""
    from triton_dist_tpu_torch.layers import sp_flash_decode as spl
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.ops import allreduce as ar
    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.ops import reduce_scatter as rs
    from triton_dist_tpu_torch.ops import sp_attention as sp

    def on_cuda(t):
        """A CPU tensor that reports the CUDA device."""
        class CudaView(torch.Tensor):
            @property
            def device(self):
                return torch.device("cuda", 0)
        return t.as_subclass(CudaView)

    for mod, name in ((sp, "sp_attention_fused_reference"),
                      (sp, "_masked_pass"),
                      (ag, "all_gather_reference"),
                      (ag, "broadcast_reference"),
                      (ar, "all_reduce_world_reference"),
                      (rs, "reduce_scatter_world_reference"),
                      (fd, "flash_decode_reference")):
        monkeypatch.setattr(mod, name, lambda *_, **__: pytest.fail(
            "CUDA call took the plain version"))
    for name in ("flash_decode_world_reference", "flash_decode_xla"):
        monkeypatch.setattr(fd, name, lambda *_, **__: pytest.fail(
            "CUDA call took the plain version"))

    def refuse(name):
        raise RuntimeError(f"no build of {name}")
    monkeypatch.setattr(_build, "load", refuse)
    q = on_cuda(torch.zeros(1, 64, 8, 64, dtype=torch.bfloat16))
    kv = on_cuda(torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16))
    x = on_cuda(torch.zeros(1, 4, 64, dtype=torch.bfloat16))
    decode = spl.SpFlashDecodeLayer(1, 64, 2, 64, device="cpu")
    calls = [
        ("sp_attention", lambda: sp.sp_ag_attention(q, kv, kv,
                                                    impl="pallas")),
        ("sp_attention", lambda: sp.sp_ag_attention_fused(q, kv, kv)),
        ("sp_attention", lambda: spl.SpAttentionLayer(impl="pallas")(
            q, kv, kv)),
        ("allgather", lambda: sp.sp_ag_attention(q, kv, kv,
                                                 impl="ag_pallas")),
        ("flash_decode", lambda: decode(on_cuda(torch.zeros(
            1, 8, 64, dtype=torch.bfloat16)), (kv, kv), 3)),
        ("allgather", lambda: ag.broadcast(x[0])),
        ("allgather", lambda: rs.reduce_scatter(x)),
    ] + [("allgather", lambda m=m: ar.all_reduce(
        x, ar.create_allreduce_context(method=m)))
        for m in ar.AllReduceMethod] + [
        ("allgather", lambda m=m: rs.reduce_scatter(
            x, rs.create_reduce_scatter_context(method=m)))
        for m in rs.ReduceScatterMethod]
    for lib, call in calls:
        with pytest.raises(RuntimeError, match=f"no build of {lib}"):
            call()


def test_sequence_world_entry_points_on_cuda_tensors_never_take_the_plain_path(
        monkeypatch):
    """Without a card, CUDA-typed calls at sequence world 4 (the decode in
    both variants, dense and paged, the ring prefill, both SP layers over
    a group) reach a kernel build and fail there instead of computing a
    plain version on the CPU."""
    from triton_dist_tpu_torch.layers import sp_flash_decode as spl
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.ops import sp_attention as sp
    from triton_dist_tpu_torch.runtime.dist import create_rank_group

    def on_cuda(t):
        """A CPU tensor that reports the CUDA device."""
        class CudaView(torch.Tensor):
            @property
            def device(self):
                return torch.device("cuda", 0)
        return t.as_subclass(CudaView)

    for mod, name in ((sp, "sp_attention_fused_reference"),
                      (sp, "_ring_pass"),
                      (fd, "flash_decode_reference"),
                      (fd, "flash_decode_world_reference"),
                      (fd, "flash_decode_paged_reference")):
        monkeypatch.setattr(mod, name, lambda *_, **__: pytest.fail(
            "CUDA call took the plain version"))

    def refuse(name):
        raise RuntimeError(f"no build of {name}")
    monkeypatch.setattr(_build, "load", refuse)
    group = create_rank_group(4, "sp", "cpu")
    q = on_cuda(torch.zeros(1, 64, 8, 64, dtype=torch.bfloat16))
    kv = on_cuda(torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16))
    qd = on_cuda(torch.zeros(1, 8, 64, dtype=torch.bfloat16))
    pool = on_cuda(torch.zeros(4 * 3, 4, 2, 64, dtype=torch.bfloat16))
    table = on_cuda(torch.zeros(4, 1, 2, dtype=torch.int32))
    decode = spl.SpFlashDecodeLayer(1, 64, 2, 64, group=group)
    calls = [
        ("flash_decode", lambda v=v: fd.gqa_fwd_batch_decode(
            qd, kv, kv, 3, fd.create_flash_decode_context(group, v)))
        for v in ("einsum", "tiled")] + [
        ("flash_decode", lambda: fd.gqa_fwd_batch_decode_paged(
            qd, pool, pool, table, 3, fd.create_flash_decode_context(
                group))),
        ("flash_decode", lambda: decode(qd, (kv, kv), 3)),
        ("sp_attention", lambda: sp.sp_ag_attention(
            q, kv, kv, sp.create_sp_attention_context(group=group),
            impl="pallas")),
        ("sp_attention", lambda: spl.SpAttentionLayer(
            impl="pallas", group=group)(q, kv, kv)),
    ]
    for lib, call in calls:
        with pytest.raises(RuntimeError, match=f"no build of {lib}"):
            call()


def test_sequence_world_entry_points_need_an_explicit_cpu(no_cuda):
    from triton_dist_tpu_torch.layers import sp_flash_decode as spl
    from triton_dist_tpu_torch.models import DenseLLM, ModelConfig
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    cfg = ModelConfig(hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=1, head_dim=8, vocab_size=32,
                      max_position_embeddings=16, dtype=torch.float32)
    for call in (lambda: DenseLLM(cfg, sp_axis="sp", sp_world=4),
                 lambda: create_rank_group(4, "sp"),
                 lambda: spl.SpFlashDecodeLayer(1, 16, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = DenseLLM(cfg, device="cpu", sp_axis="sp", sp_world=4)
    assert model.sp_group.device == torch.device("cpu")


def test_sequence_world_sources_target_sm90a_through_cooperative_launches():
    from triton_dist_tpu_torch.ops import _build
    for name, entries, kernels in (
            ("flash_decode", ("tdt_flash_decode_world_grid",
                              "tdt_flash_decode_world"),
             ("_decode_kernel", "_tiled_decode_kernel",
              "_exchange_and_merge")),
            ("sp_attention", ("tdt_sp_ring_attention",),
             ("_sp_fused_kernel",))):
        text = _build.SOURCES[name].read_text()
        assert '#include "shmem.cuh"' in text
        assert "cudaLaunchCooperativeKernel" in text
        assert "tdt_putmem_signal_block" in text     # pushes with signals
        assert "tdt_signal_wait_until" in text
        for entry in entries + kernels:     # and the TPU kernels replaced
            assert entry in text
        # Fixed-order sums only (flash decode's one atomic, the world-1
        # merge's arrival ticket, is held by the test above).
        assert re.findall(r"\batomic\w+\(", text) in (
            [], ["atomicAdd("] if name == "flash_decode" else [])


def test_sp_attention_and_collective_sources_target_sm90a_without_atomics():
    from triton_dist_tpu_torch.ops import _build
    src = _build.SOURCES["sp_attention"]
    assert src.is_file() and src.is_relative_to(PACKAGE)
    cmd = _build.nvcc_command(src, pathlib.Path("/tmp/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(src) in cmd
    text = src.read_text()
    assert 'extern "C"' in text and '#include "gemm_common.cuh"' in text
    for entry in ("tdt_sp_attention", "tdt_error_string", "wgmma_m64n128k16",
                  "_sp_fused_kernel"):             # the kernel it replaces
        assert entry in text
    copy = _build.SOURCES["allgather"].read_text()
    for kernel in ("_one_shot_ar_kernel", "_recursive_doubling_ar_kernel",
                   "_two_shot_ar_kernel", "_ring_rs_kernel",
                   "_one_shot_rs_kernel", "_broadcast_kernel"):
        assert kernel in copy
    for body in (text, copy):
        for atomic in ("atomicAdd", "atomicMax", "atomicCAS", "atomicExch"):
            assert atomic not in body           # fixed-order sums only
        for library in ("cublas", "cudnn", "cutlass::gemm::device",
                        "torch/", "scaled_dot_product"):
            assert library not in body.lower()  # no library kernel


def test_expert_parallel_modules_are_guarded():
    """The modules of the EP slice import, and are held to the import
    rules above (every port module is)."""
    names = _module_names()
    for mod in ("runtime.dist", "runtime.symm_mem", "ops.all_to_all",
                "layers.ep_a2a", "layers.ep_moe"):
        assert f"triton_dist_tpu_torch.{mod}" in names
    for path in ("runtime/dist.py", "runtime/symm_mem.py",
                 "ops/all_to_all.py", "layers/ep_a2a.py",
                 "layers/ep_moe.py"):
        assert PACKAGE / path in PORT_FILES


def test_expert_parallel_entry_points_need_an_explicit_cpu(no_cuda):
    from triton_dist_tpu_torch.models import ModelConfig, Qwen3MoE
    from triton_dist_tpu_torch.ops.all_to_all import create_all_to_all_context
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    cfg = ModelConfig(hidden_size=16, moe_intermediate_size=16,
                      intermediate_size=0, num_hidden_layers=1,
                      num_attention_heads=4, num_key_value_heads=4,
                      head_dim=4, vocab_size=32, max_position_embeddings=16,
                      num_experts=8, num_experts_per_tok=2,
                      dtype=torch.float32)
    for call in (lambda: create_rank_group(4),
                 lambda: create_all_to_all_context(),
                 lambda: Qwen3MoE(cfg, moe_parallel="ep", world=4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = Qwen3MoE(cfg, device="cpu", moe_parallel="ep", world=4)
    assert model.group.device == torch.device("cpu")


def test_all_to_all_on_cuda_tensors_never_takes_the_plain_path(monkeypatch):
    """Without a card, CUDA-typed calls of fast_all_to_all (both wires)
    reach the kernel build and fail there instead of computing the plain
    version on the CPU."""
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import all_to_all as a2a
    from triton_dist_tpu_torch.runtime.dist import create_rank_group

    def on_cuda(t):
        """A CPU tensor that reports the CUDA device."""
        class CudaView(torch.Tensor):
            @property
            def device(self):
                return torch.device("cuda", 0)
        return t.as_subclass(CudaView)

    monkeypatch.setattr(a2a, "fast_all_to_all_reference",
                        lambda *_, **__: pytest.fail(
                            "CUDA call took the plain version"))

    def refuse(name):
        raise RuntimeError(f"no build of {name}")
    monkeypatch.setattr(_build, "load", refuse)
    ctx = a2a.create_all_to_all_context(create_rank_group(2, device="cpu"),
                                        capacity=8)
    send = on_cuda(torch.zeros(4, 8, 16, dtype=torch.bfloat16))
    counts = on_cuda(torch.full((4,), 3, dtype=torch.int32))
    for call in (lambda: a2a.fast_all_to_all(send, counts, ctx),
                 lambda: a2a.fast_all_to_all_fp8(send, counts, ctx)):
        with pytest.raises(RuntimeError, match="no build of all_to_all"):
            call()


def test_all_to_all_source_targets_sm90a_and_synchronises_by_signals():
    from triton_dist_tpu_torch.ops import _build
    src = _build.SOURCES["all_to_all"]
    assert src.is_file() and src.is_relative_to(PACKAGE)
    cmd = _build.nvcc_command(src, pathlib.Path("/tmp/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(src) in cmd
    text = src.read_text()
    assert 'extern "C"' in text and '#include "shmem.cuh"' in text
    for entry in ("tdt_all_to_all", "tdt_all_to_all_grid",
                  "tdt_error_string", "cudaLaunchCooperativeKernel",
                  "_a2a_kernel", "a2a_send_peer", "a2a_wait_src",
                  "tdt_rank_ptr", "tdt_putmem_block_x4",
                  "tdt_signal_wait_all"):
        assert entry in text
    # No grid barrier before the pushes: the receive buffer exists before
    # the launch, and epochs keep stale signals from satisfying a wait.
    assert "tdt_barrier_all" not in text
    header = _build.CSRC_DIR / "shmem.cuh"
    assert header in _build.HEADERS
    shmem = header.read_text()
    for entry in ("tdt_peer_ptr", "tdt_rank_ptr", "tdt_putmem_block",
                  "tdt_putmem_block_x4", "st.release.gpu",
                  "ld.acquire.gpu", "tdt_signal_wait_until",
                  "tdt_barrier_all"):
        assert entry in shmem
    for body in (text, shmem):
        for library in ("cublas", "nccl", "nvshmem", "torch/"):
            assert library not in body.lower()  # no library exchange


def test_tensor_world_moe_entry_points_on_cuda_tensors_never_take_the_plain_path(
        monkeypatch):
    """Without a card, CUDA-typed calls at tensor world 4 -- the world-W
    all-gather in every method, the broadcast, ``ag_pallas`` over it and
    the world-W MoE-reduce -- reach a kernel build and fail there instead
    of computing a plain version on the CPU."""
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
    from triton_dist_tpu_torch.ops import sp_attention as sp
    from triton_dist_tpu_torch.runtime.dist import create_rank_group

    def on_cuda(t):
        """A CPU tensor that reports the CUDA device."""
        class CudaView(torch.Tensor):
            @property
            def device(self):
                return torch.device("cuda", 0)
        return t.as_subclass(CudaView)

    for mod, name in ((ag, "all_gather_reference"),
                      (ag, "broadcast_reference"),
                      (mrs, "moe_reduce_rs_reference"),
                      (mrs, "moe_reduce_rs_world_reference"),
                      (sp, "_masked_pass")):
        monkeypatch.setattr(mod, name, lambda *_, **__: pytest.fail(
            "CUDA call took the plain version"))

    def refuse(name):
        raise RuntimeError(f"no build of {name}")
    monkeypatch.setattr(_build, "load", refuse)
    group = create_rank_group(4, device="cpu")
    x = on_cuda(torch.zeros(8, 16, dtype=torch.bfloat16))
    q = on_cuda(torch.zeros(1, 8, 4, 16, dtype=torch.bfloat16))
    sp_ctx = sp.create_sp_attention_context(
        group=create_rank_group(4, "sp", device="cpu"))
    act = on_cuda(torch.zeros(8, 16, dtype=torch.bfloat16))
    wd = on_cuda(torch.zeros(3, 16, 8, dtype=torch.bfloat16))
    ids = on_cuda(torch.zeros(8, dtype=torch.int32))
    wts = on_cuda(torch.ones(4, 2))
    rs_ctx = mrs.create_moe_rs_context(num_experts=3, topk=2, world_size=4)
    calls = [("allgather", lambda m=m: ag.all_gather(
        x, ag.create_allgather_context(method=m, group=group)))
        for m in (ag.AllGatherMethod.AUTO, ag.AllGatherMethod.RING_1D,
                  ag.AllGatherMethod.RING_BIDIR,
                  ag.AllGatherMethod.FULL_MESH_PUSH)] + [
        ("allgather", lambda: ag.broadcast(
            x, 1, ag.create_allgather_context(group=group))),
        ("allgather", lambda: sp.sp_ag_attention(q, q, q, sp_ctx,
                                                 impl="ag_pallas")),
    ] + [("moe_rs", lambda impl=impl: mrs.moe_reduce_rs(
        act, wd, ids, wts, rs_ctx, impl=impl)) for impl in ("ring", "xla")]
    for lib, call in calls:
        with pytest.raises(RuntimeError, match=f"no build of {lib}"):
            call()


def test_ag_group_gemm_world_on_cuda_tensors_never_takes_the_plain_path(
        monkeypatch):
    """Without a card, CUDA-typed calls of ag_group_gemm over a world-4
    rank group reach a kernel build and fail there instead of computing
    a plain version on the CPU: impl "fused" the ring kernel's, "xla" and
    "ring" the grouped GEMM's (once a rank, on its shard)."""
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.runtime.dist import create_rank_group

    def on_cuda(t):
        """A CPU tensor that reports the CUDA device."""
        class CudaView(torch.Tensor):
            @property
            def device(self):
                return torch.device("cuda", 0)
        return t.as_subclass(CudaView)

    for name in ("ag_group_gemm_reference", "ag_group_gemm_ring_reference",
                 "grouped_matmul_reference"):
        monkeypatch.setattr(gg, name, lambda *_, **__: pytest.fail(
            "CUDA call took the plain version"))

    def refuse(name):
        raise RuntimeError(f"no build of {name}")
    monkeypatch.setattr(_build, "load", refuse)
    ctx = gg.create_ag_group_gemm_context(
        group=create_rank_group(4, device="cpu"))
    x = on_cuda(torch.zeros(8, 16, dtype=torch.bfloat16))
    w = on_cuda(torch.zeros(3, 16, 32, dtype=torch.bfloat16))
    ids = on_cuda(torch.zeros(8, dtype=torch.int32))
    for impl, lib in (("fused", "ag_group_gemm"), ("xla", "group_gemm"),
                      ("ring", "group_gemm")):
        with pytest.raises(RuntimeError, match=f"no build of {lib}$"):
            gg.ag_group_gemm(x, w, ids, 3, ctx, impl=impl)


def test_ag_group_gemm_source_targets_sm90a_through_cooperative_launches():
    from triton_dist_tpu_torch.ops import _build
    src = _build.SOURCES["ag_group_gemm"]
    assert src.is_file() and src.is_relative_to(PACKAGE)
    cmd = _build.nvcc_command(src, pathlib.Path("/tmp/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(src) in cmd
    text = src.read_text()
    assert 'extern "C"' in text and '#include "shmem.cuh"' in text
    assert '#include "group_gemm.cuh"' in text   # the world-1 tile bodies
    for entry in ("cudaLaunchCooperativeKernel", "tdt_putmem_block_x4",
                  "tdt_signal_wait_until", "tdt_signal_acquire",
                  "gg_wg_load", "gg_wg_mma", "gg_fma_tile",
                  "tdt_ag_group_gemm_grid", "tdt_ag_group_gemm",
                  "tdt_error_string",
                  "_ag_group_gemm_kernel"):     # the TPU kernel it replaces
        assert entry in text
    for atomic in ("atomicAdd", "atomicMax", "atomicCAS", "atomicExch"):
        assert atomic not in text             # fixed-order sums only
    for library in ("cublas", "cutlass::gemm::device", "torch/"):
        assert library not in text.lower()


def test_moe_reduce_rs_fused_world_on_cuda_tensors_never_takes_the_plain_path(
        monkeypatch):
    """Without a card, a CUDA-typed ``moe_reduce_rs(impl="fused")`` over
    world 4 reaches the ring kernel's build and fails there instead of
    computing a plain version on the CPU."""
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs

    def on_cuda(t):
        """A CPU tensor that reports the CUDA device."""
        class CudaView(torch.Tensor):
            @property
            def device(self):
                return torch.device("cuda", 0)
        return t.as_subclass(CudaView)

    for name in ("moe_reduce_rs_reference", "moe_reduce_rs_world_reference",
                 "moe_reduce_rs_fused_world_reference", "_fused_partials"):
        monkeypatch.setattr(mrs, name, lambda *_, **__: pytest.fail(
            "CUDA call took the plain version"))

    def refuse(name):
        raise RuntimeError(f"no build of {name}")
    monkeypatch.setattr(_build, "load", refuse)
    ctx = mrs.create_moe_rs_context(num_experts=3, topk=2, world_size=4)
    act = on_cuda(torch.zeros(8, 16, dtype=torch.bfloat16))
    wd = on_cuda(torch.zeros(3, 16, 8, dtype=torch.bfloat16))
    ids = on_cuda(torch.zeros(8, dtype=torch.int32))
    wts = on_cuda(torch.ones(4, 2))
    with pytest.raises(RuntimeError, match="no build of moe_rs_ring$"):
        mrs.moe_reduce_rs(act, wd, ids, wts, ctx, impl="fused")
    assert ctx.state is None                # nothing allocated before it


def test_moe_rs_ring_source_targets_sm90a_through_cooperative_launches():
    from triton_dist_tpu_torch.ops import _build
    src = _build.SOURCES["moe_rs_ring"]
    assert src.is_file() and src.is_relative_to(PACKAGE)
    cmd = _build.nvcc_command(src, pathlib.Path("/tmp/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(src) in cmd
    text = src.read_text()
    assert 'extern "C"' in text and '#include "shmem.cuh"' in text
    assert '#include "group_gemm.cuh"' in text   # the world-1 tile bodies
    for entry in ("cudaLaunchCooperativeKernel", "tdt_signal_release",
                  "tdt_signal_acquire", "consumers_release",
                  "gg_wg_load", "gg_wg_mma", "gg_fma_tile", "launch_schedule",
                  "tdt_moe_rs_ring_tile_signals", "tdt_moe_rs_ring_grid",
                  "tdt_moe_rs_ring", "tdt_error_string",
                  "_moe_rs_fused_kernel"):      # the TPU kernel it replaces
        assert entry in text
    for atomic in ("atomicAdd", "atomicMax", "atomicCAS", "atomicExch"):
        assert atomic not in text             # fixed-order sums only
    for library in ("cublas", "cutlass::gemm::device", "torch/", "nccl",
                    "nvshmem"):
        assert library not in text.lower()


def test_world_collectives_on_cuda_tensors_never_take_the_plain_path(
        monkeypatch):
    """Without a card, CUDA-typed world-4 calls of all_reduce (every
    method) and reduce_scatter (every method) over a rank group reach the
    world-W kernel's build and fail there instead of computing a plain
    version on the CPU; a world-4 context without a group raises
    ValueError first."""
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import allreduce as ar
    from triton_dist_tpu_torch.ops import reduce_scatter as rs
    from triton_dist_tpu_torch.runtime.dist import create_rank_group

    def on_cuda(t):
        """A CPU tensor that reports the CUDA device."""
        class CudaView(torch.Tensor):
            @property
            def device(self):
                return torch.device("cuda", 0)
        return t.as_subclass(CudaView)

    for mod, name in ((ar, "all_reduce_world_reference"),
                      (rs, "reduce_scatter_world_reference")):
        monkeypatch.setattr(mod, name, lambda *_, **__: pytest.fail(
            "CUDA call took the plain version"))

    def refuse(name):
        raise RuntimeError(f"no build of {name}")
    monkeypatch.setattr(_build, "load", refuse)
    group = create_rank_group(4, device="cpu")
    x = on_cuda(torch.zeros(4, 8, 64, dtype=torch.bfloat16))
    calls = [lambda m=m: ar.all_reduce(x, ar.create_allreduce_context(
        method=m, group=group)) for m in ar.AllReduceMethod]
    calls += [lambda m=m: rs.reduce_scatter(
        x, rs.create_reduce_scatter_context(method=m, group=group))
        for m in rs.ReduceScatterMethod]
    for call in calls:
        with pytest.raises(RuntimeError, match="no build of reduce_world$"):
            call()
    with pytest.raises(ValueError, match="group"):
        ar.all_reduce(x, ar.create_allreduce_context(world_size=4))
    with pytest.raises(ValueError, match="group"):
        rs.reduce_scatter(x, rs.create_reduce_scatter_context(world_size=4))


def test_reduce_world_source_targets_sm90a_through_cooperative_launches():
    from triton_dist_tpu_torch.ops import _build
    src = _build.SOURCES["reduce_world"]
    assert src.is_file() and src.is_relative_to(PACKAGE)
    cmd = _build.nvcc_command(src, pathlib.Path("/tmp/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(src) in cmd
    text = src.read_text()
    assert 'extern "C"' in text and '#include "shmem.cuh"' in text
    for entry in ("cudaLaunchCooperativeKernel", "tdt_signal_release",
                  "tdt_rank_ptr", "tdt_signal_acquire",
                  "tdt_reduce_world_workspace",
                  "tdt_reduce_world_grid", "tdt_reduce_scatter_world",
                  "tdt_all_reduce_world", "tdt_error_string",
                  # the TPU kernels it replaces
                  "_ring_rs_kernel", "_one_shot_rs_kernel",
                  "_one_shot_ar_kernel", "_recursive_doubling_ar_kernel",
                  "_two_shot_ar_kernel"):
        assert entry in text
    for atomic in ("atomicAdd", "atomicMax", "atomicCAS", "atomicExch"):
        assert atomic not in text             # fixed-order sums only
    for library in ("cublas", "cutlass", "torch/", "nccl", "nvshmem"):
        assert library not in text.lower()


def test_p2p_entry_points_on_cuda_tensors_never_take_the_plain_path(
        monkeypatch):
    """Without a card, CUDA-typed world-4 calls of pp_shift (impl
    "pallas"), CommOp.send, pipeline_forward(impl="pallas") and
    symm_ship reach the shift kernel's build and fail there instead of
    rolling the blocks on the CPU; impl "xla" is the plain roll by
    design, and a context without a group raises ValueError first."""
    from triton_dist_tpu_torch.layers import p2p as lp
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import p2p
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    from triton_dist_tpu_torch.serving import kv_stream as ks

    def on_cuda(t):
        """A CPU tensor that reports the CUDA device."""
        class CudaView(torch.Tensor):
            @property
            def device(self):
                return torch.device("cuda", 0)
        return t.as_subclass(CudaView)

    for mod in (p2p, ks):
        monkeypatch.setattr(mod, "pp_shift_reference",
                            lambda *_, **__: pytest.fail(
                                "CUDA call took the plain version"))

    def refuse(name):
        raise RuntimeError(f"no build of {name}")
    monkeypatch.setattr(_build, "load", refuse)
    group = create_rank_group(4, "pp", device="cpu")
    ctx = p2p.create_p2p_context(group)
    x = on_cuda(torch.zeros(16, 64, dtype=torch.bfloat16))
    payload = on_cuda(torch.zeros(4 * 37, dtype=torch.uint8))
    calls = [lambda: p2p.pp_shift(x, ctx),
             lambda: p2p.pp_shift(x, ctx, delta=-6),
             lambda: lp.CommOp(group=group).send(x),
             lambda: lp.pipeline_forward(lambda r, h: h, x, group,
                                         impl="pallas"),
             lambda: ks.symm_ship(payload, create_rank_group(
                 4, "tp", device="cpu"))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no build of p2p$"):
            call()
    assert ctx.state is None                 # nothing allocated before it
    with pytest.raises(ValueError, match="group"):
        p2p.pp_shift(x, p2p.create_p2p_context(world_size=4))


def test_p2p_source_targets_sm90a_through_a_cooperative_launch():
    from triton_dist_tpu_torch.ops import _build
    src = _build.SOURCES["p2p"]
    assert src.is_file() and src.is_relative_to(PACKAGE)
    cmd = _build.nvcc_command(src, pathlib.Path("/tmp/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(src) in cmd
    text = src.read_text()
    assert 'extern "C"' in text and '#include "shmem.cuh"' in text
    for entry in ("cudaLaunchCooperativeKernel", "tdt_putmem_block_x4",
                  "tdt_signal_release", "tdt_signal_wait_all",
                  "tdt_rank_ptr", "tdt_shift_grid",
                  "tdt_shift_world", "tdt_error_string",
                  # the TPU kernels it replaces
                  "_shift_kernel", "_ship_kernel"):
        assert entry in text
    for atomic in ("atomicAdd", "atomicMax", "atomicCAS", "atomicExch"):
        assert atomic not in text
    for library in ("cublas", "cutlass", "torch/", "nccl", "nvshmem",
                    "cudamemcpy"):
        assert library not in text.lower()
