"""Guards of the PyTorch port's boundaries: it imports neither jax nor the
JAX package, it never falls back to the CPU when nobody asked for it,
and its kernels build for Hopper (sm_90a) from sources in the repo."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "triton_dist_tpu_torch"
PORT_FILES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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


def test_ag_gemm_source_targets_sm90a_without_atomics():
    from triton_dist_tpu_torch.ops import _build
    src = _build.SOURCES["ag_gemm"]
    assert src.is_file() and src.is_relative_to(PACKAGE)
    cmd = _build.nvcc_command(src, pathlib.Path("/tmp/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(src) in cmd
    text = src.read_text()
    assert 'extern "C"' in text and '#include "gemm_common.cuh"' in text
    for entry in ("tdt_ag_gemm_plan", "tdt_ag_gemm", "tdt_ag_swiglu"):
        assert entry in text
    # The note at the top names the TPU kernels it replaces.
    for kernel in ("_ag_gemm_hbm_nb_kernel", "_ag_swiglu_hbm_kernel",
                   "_gemm_rs_hbm_kernel"):
        assert kernel in text
    header = _build.CSRC_DIR / "gemm_common.cuh"
    assert header in _build.HEADERS
    for path in (src, header):
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
    for atomic in ("atomicAdd", "atomicMax", "atomicCAS", "atomicExch"):
        assert atomic not in text             # fixed-order sums only


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
                                   "sp_attention"}
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
                      (ar, "all_reduce_reference"),
                      (rs, "reduce_scatter_reference"),
                      (fd, "flash_decode_reference")):
        monkeypatch.setattr(mod, name, lambda *_, **__: pytest.fail(
            "CUDA call took the plain version"))
    monkeypatch.setattr(spl, "flash_decode_reference",
                        lambda *_, **__: pytest.fail(
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


def test_sp_attention_and_collective_sources_target_sm90a_without_atomics():
    from triton_dist_tpu_torch.ops import _build
    src = _build.SOURCES["sp_attention"]
    assert src.is_file() and src.is_relative_to(PACKAGE)
    cmd = _build.nvcc_command(src, pathlib.Path("/tmp/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(src) in cmd
    text = src.read_text()
    assert 'extern "C"' in text and '#include "gemm_common.cuh"' in text
    for entry in ("tdt_sp_attention", "tdt_error_string", "mma_bf16",
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
