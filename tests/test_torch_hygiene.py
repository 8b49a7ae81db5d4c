"""Port hygiene: ``repro_torch`` imports neither JAX nor the reference
package, its entry points default to the card and never fall back, and the
CUDA wrappers raise rather than run the plain version on a non-CPU
tensor."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.int8_matmul import ops as i8_ops  # noqa: E402
from repro_torch.kernels.lut_exp import ops as lut_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.streaming_attention import ops as sa_ops  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.params import from_flat, init_params, param_paths  # noqa: E402
from repro_torch.serving import EngineCore, Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(n for n in sys.modules if n.startswith('jax')"
        " or n.split('.')[0] == 'repro')\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20, out.stdout        # every submodule was imported


@pytest.mark.parametrize("module", ["repro_torch.serving.metrics",
                                    "repro_torch.serving.tracing",
                                    "repro_torch.serving.graphs"])
def test_serving_obs_modules_import_no_jax(module):
    """Each module of the serving observability and the captured step,
    imported alone in a fresh process, pulls in neither JAX nor the
    reference package (whose ``serving/metrics.py`` it copies)."""
    code = (f"import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            f"bad = sorted(n for n in sys.modules if n.startswith('jax')"
            f" or n.split('.')[0] == 'repro')\n"
            f"assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("name", ["deepseek-7b-smoke", "bert-base-smoke"])
def test_params_default_to_card_and_raise_without_one(no_card, name):
    """``init_params``, ``from_flat`` and ``Model.init`` run on the card
    unless told ``cpu``, and raise without one."""
    cfg = get_config(name)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, "cpu")
    assert all(t.device.type == "cpu" for t in params.values())
    flat = {param_paths(cfg)[k]: v.float().numpy() for k, v in params.items()}
    assert from_flat(flat, cfg, "cpu")["embed"].device.type == "cpu"
    for make in (lambda: init_params(cfg, gen), lambda: from_flat(flat, cfg),
                 lambda: build_model(cfg).init(gen)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_engine_without_device_raises_without_card(no_card):
    cfg = get_config("deepseek-7b-smoke")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineCore(cfg, params, lanes=2, page_size=8, num_pages=8)
    EngineCore(cfg, params, lanes=2, page_size=8, num_pages=8, device="cpu")


@pytest.mark.parametrize("kw", [dict(mode="padded"), dict(prefix_cache=True),
                                dict(speculative=True), dict(mesh=2)])
def test_later_slices_raise_not_implemented(kw):
    cfg = get_config("deepseek-7b-smoke")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        EngineCore(cfg, params, device="cpu", **kw)


def test_sampled_request_raises_not_implemented():
    cfg = get_config("deepseek-7b-smoke")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = EngineCore(cfg, params, lanes=2, page_size=8, num_pages=8,
                     device="cpu")
    with pytest.raises(NotImplementedError, match="sampling"):
        eng.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                           max_new=2, temperature=0.7))


def test_engine_rejects_params_on_another_device():
    cfg = get_config("deepseek-7b-smoke")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params["embed"] = params["embed"].to("meta")
    with pytest.raises(ValueError, match="meta"):
        EngineCore(cfg, params, device="cpu")


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrappers' card
    branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(a):
    return torch.as_tensor(a).as_subclass(_FakeCuda)


@pytest.fixture
def no_toolchain(monkeypatch, tmp_path):
    """No nvcc anywhere and an empty build cache."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})


def _forbid(monkeypatch, module, name):
    def fail(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(module, name, fail)


def test_lut_exp_cuda_tensor_raises_without_toolchain(no_toolchain,
                                                      monkeypatch):
    _forbid(monkeypatch, lut_ops, "lut_exp_ref")
    before = lut_ops.lut_exp.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        lut_ops.lut_exp(_fake(np.zeros(8, np.float32)))
    assert lut_ops.lut_exp.launches == before


def test_paged_attention_cuda_tensor_raises_without_toolchain(no_toolchain,
                                                              monkeypatch):
    _forbid(monkeypatch, pa_ops, "paged_attention_reference")
    q = _fake(np.zeros((2, 4, 1, 16), np.float32))
    pool = _fake(np.zeros((5, 2, 8, 16), np.float32))
    tbl = _fake(np.zeros((2, 2), np.int32))
    lens = _fake(np.ones(2, np.int32))
    before = pa_ops.paged_attention.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        pa_ops.paged_attention(q, pool, pool, tbl, lens)
    assert pa_ops.paged_attention.launches == before


def test_paged_combine_cuda_tensor_raises_without_toolchain(no_toolchain,
                                                            monkeypatch):
    _forbid(monkeypatch, pa_ops, "paged_combine_reference")
    part = _fake(np.zeros((2, 2, 3, 4), np.float32))
    acc = _fake(np.zeros((2, 2, 3, 4, 16), np.float32))
    lens = _fake(np.ones(2, np.int32))
    before = pa_ops.paged_attention.combine_launches
    with pytest.raises(RuntimeError, match="nvcc"):
        pa_ops.paged_combine(part, part, acc, lens, page_size=8, kv_split=2)
    with pytest.raises(ValueError, match="kv_len"):
        pa_ops.paged_combine(part, part, acc, _fake(np.ones(3, np.int32)),
                             page_size=8, kv_split=2)
    assert pa_ops.paged_attention.combine_launches == before


def test_streaming_attention_cuda_tensor_raises_without_toolchain(
        no_toolchain, monkeypatch):
    _forbid(monkeypatch, sa_ops, "attention_ref")
    q = _fake(np.zeros((2, 4, 5, 16), np.float32))
    kv = _fake(np.zeros((2, 2, 7, 16), np.float32))
    before = sa_ops.streaming_attention.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        sa_ops.streaming_attention(q, kv, kv, causal=True)
    assert sa_ops.streaming_attention.launches == before


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "tensor_core"),
                                           (torch.float32, "cuda_core")])
@pytest.mark.parametrize("d", sa_ops.HEAD_DIMS)
def test_streaming_attention_variant_follows_dtype(dtype, variant, d):
    """bf16 runs on the tensor-core kernel at every head dim (8 included),
    f32 on the CUDA-core kernel."""
    assert sa_ops.kernel_variant(dtype, d) == variant


@pytest.mark.parametrize("dtype,d,err", [
    (torch.float16, 64, TypeError), (torch.float64, 64, TypeError),
    (torch.int8, 64, TypeError), (torch.bfloat16, 24, ValueError),
    (torch.bfloat16, 256, ValueError), (torch.float32, 4, ValueError)])
def test_streaming_attention_variant_refuses(dtype, d, err):
    with pytest.raises(err):
        sa_ops.kernel_variant(dtype, d)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_streaming_attention_cuda_tensor_counts_no_refused_launch(
        dtype, no_toolchain, monkeypatch):
    """A CUDA tensor of either dtype goes to its kernel: with no nvcc the
    call raises, neither the plain version nor the other kernel is taken,
    and no count moves."""
    _forbid(monkeypatch, sa_ops, "attention_ref")
    q = _fake(torch.zeros((1, 4, 5, 8), dtype=dtype))
    kv = _fake(torch.zeros((1, 2, 7, 8), dtype=dtype))
    before = dict(sa_ops.streaming_attention.launches_by_variant)
    total = sa_ops.streaming_attention.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        sa_ops.streaming_attention(q, kv, kv)
    assert sa_ops.streaming_attention.launches_by_variant == before
    assert sa_ops.streaming_attention.launches == total
    assert set(before) == {"tensor_core", "cuda_core"}


def test_softmax_exp_check_goes_to_the_card(no_toolchain, monkeypatch):
    """The softmax-exponential check takes the plain LUT on the CPU and
    on a CUDA tensor reaches the build (here: raises without nvcc); other
    dtypes and devices are refused."""
    x = torch.tensor([0.0, -1.0, -100.0])
    assert torch.equal(sa_ops.softmax_exp(x), lut_ops.lut_exp_ref(x))
    _forbid(monkeypatch, sa_ops, "lut_exp_ref")
    with pytest.raises(RuntimeError, match="nvcc"):
        sa_ops.softmax_exp(_fake(np.zeros(8, np.float32)))
    with pytest.raises(ValueError):
        sa_ops.softmax_exp(_fake(np.zeros(8, np.float64)))
    with pytest.raises(ValueError, match="unsupported device"):
        sa_ops.softmax_exp(torch.zeros(4, device="meta"))


@pytest.mark.parametrize("bad", [
    dict(q_dtype=torch.float16), dict(kv_dtype=torch.bfloat16), dict(d=24),
    dict(cap=0.0), dict(window=0), dict(exp_mode="exp2"),
    dict(q_offset=torch.tensor(3)), dict(kv_len=-1), dict(hkv=3)])
def test_streaming_attention_card_checks_raise(bad, no_toolchain,
                                               monkeypatch):
    """What the kernel does not take is refused before any launch."""
    _forbid(monkeypatch, sa_ops, "attention_ref")
    d, hkv = bad.pop("d", 16), bad.pop("hkv", 2)
    q = _fake(torch.zeros((2, 4, 5, d), dtype=bad.pop("q_dtype", torch.float32)))
    kv = _fake(torch.zeros((2, hkv, 7, d),
                           dtype=bad.pop("kv_dtype", torch.float32)))
    with pytest.raises((TypeError, ValueError)):
        sa_ops.streaming_attention(q, kv, kv, **bad)


def test_streaming_attention_kernel_refuses_a_gradient(monkeypatch):
    """Autograd through the card path raises and names the training slice
    (the launch itself is stubbed: there is no card here)."""
    monkeypatch.setattr(sa_ops, "_launch",
                        lambda q, k, v, **kw: torch.zeros(q.shape))
    q = _fake(np.zeros((1, 2, 5, 16), np.float32)).requires_grad_()
    kv = _fake(np.zeros((1, 2, 5, 16), np.float32))
    out = sa_ops.streaming_attention(q, kv, kv)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


def test_wrappers_refuse_other_devices(monkeypatch):
    _forbid(monkeypatch, lut_ops, "lut_exp_ref")
    _forbid(monkeypatch, pa_ops, "paged_attention_reference")
    _forbid(monkeypatch, sa_ops, "attention_ref")
    with pytest.raises(ValueError, match="unsupported device"):
        sa_ops.streaming_attention(*(torch.zeros((1, 2, 4, 8), device="meta"),) * 3)
    with pytest.raises(ValueError, match="unsupported device"):
        lut_ops.lut_exp(torch.zeros(4, device="meta"))
    m = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        pa_ops.paged_attention(m(1, 2, 1, 8), m(3, 2, 4, 8), m(3, 2, 4, 8),
                               m(1, 1, dt=torch.int32), m(1, dt=torch.int32))


@pytest.mark.parametrize("bad", [
    dict(q_dtype=torch.float16), dict(cap=0.0), dict(window=0),
    dict(exp_mode="exp2"), dict(ps=48), dict(kv_split=0)])
def test_paged_attention_card_checks_raise(bad, no_toolchain, monkeypatch):
    """What the kernel does not take is refused before any launch."""
    _forbid(monkeypatch, pa_ops, "paged_attention_reference")
    ps = bad.pop("ps", 8)
    dt = bad.pop("q_dtype", torch.float32)
    q = _fake(torch.zeros((2, 4, 1, 16), dtype=dt))
    pool = _fake(np.zeros((5, 2, ps, 16), np.float32))
    tbl = _fake(np.zeros((2, 2), np.int32))
    lens = _fake(np.ones(2, np.int32))
    with pytest.raises((TypeError, ValueError)):
        pa_ops.paged_attention(q, pool, pool, tbl, lens, **bad)


def test_build_flags_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert {"-O3", "-shared", "-std=c++17"} <= set(build.NVCC_FLAGS)
    assert set(build.sources()) == {"int8_matmul", "lut_exp",
                                    "paged_attention", "quantize",
                                    "streaming_attention"}
    assert len(build.source_hash()) == 16


def _imports(path):
    """Every module a script imports, at any depth, read from its AST."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    return names


def _jax_or_reference(names):
    return sorted(n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro"))


def test_chip_smoke_imports_no_jax_and_no_reference_package():
    """Every import in ``chip_smoke.py``, at any depth, read from its AST:
    the script runs where there is no JAX."""
    names = _imports(ROOT / "chip_smoke.py")
    assert "repro_torch.kernels.int8_matmul" in names     # the walk sees nested imports
    bad = _jax_or_reference(names)
    assert not bad, bad


VARIANT_TOOL = ROOT / "tools" / "streaming_attention_variants.py"


def _variant_tool():
    import importlib.util
    spec = importlib.util.spec_from_file_location("sa_variants", VARIANT_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_variant_tool_imports_no_jax_and_no_reference_package():
    """The kernel-variant timing script runs on the card's machine too."""
    names = _imports(VARIANT_TOOL)
    assert {"chip_smoke", "repro_torch.kernels"} <= names
    bad = _jax_or_reference(names)
    assert not bad, bad


@pytest.mark.parametrize("name", ["no_exp", "no_p_lo", "p_rounded",
                                  "no_exp_no_p_lo", "table_32", "no_reg_cap"])
def test_variant_tool_edits_match_the_shipped_kernel(name, tmp_path):
    """Each design variant's replacements find their lines in the shipped
    sources exactly once, so the variants stay the shipped kernel but for
    what they name."""
    tool = _variant_tool()
    shipped = {p.name: p.read_text() for p in build.CSRC.iterdir()
               if p.suffix in (".cu", ".cuh")}
    files = tool.variant_sources(name, build.CSRC)
    edited = {f for f, _, _ in tool.VARIANTS[name][1]}
    assert set(files) == set(shipped)
    assert {f for f in files if files[f] != shipped[f]} == edited
    for f, old, new in tool.VARIANTS[name][1]:
        assert old not in files[f] or old in new
    f0, old0, _ = tool.VARIANTS[name][1][0]         # a source that drifted
    for f, text in shipped.items():
        (tmp_path / f).write_text(text.replace(old0, "") if f == f0 else text)
    with pytest.raises(ValueError, match="expected once"):
        tool.variant_sources(name, tmp_path)


INT8_VARIANT_TOOL = ROOT / "tools" / "int8_matmul_variants.py"


def _int8_variant_tool():
    import importlib.util
    spec = importlib.util.spec_from_file_location("i8_variants",
                                                  INT8_VARIANT_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_int8_variant_tool_imports_no_jax_and_no_reference_package():
    names = _imports(INT8_VARIANT_TOOL)
    assert {"chip_smoke", "repro_torch.kernels"} <= names
    assert not _jax_or_reference(names)


@pytest.mark.parametrize("name", ["no_stores", "loads_only", "products_only",
                                  "stages_2", "wait_0"])
def test_int8_variant_tool_edits_match_the_shipped_kernel(name):
    """Each diagnostic variant's replacements find their lines in the
    shipped int8 kernel exactly once, and change nothing else."""
    tool = _int8_variant_tool()
    shipped = {p.name: p.read_text() for p in build.CSRC.iterdir()
               if p.suffix in (".cu", ".cuh")}
    files = tool.variant_sources(name, build.CSRC)
    assert set(files) == set(shipped)
    assert {f for f in files if files[f] != shipped[f]} == {"int8_matmul.cu"}
    for f, old, new in tool.VARIANTS[name][1]:
        assert old not in files[f] or old in new


def _fake_qtensor(k=64, n=32):
    return quant.QTensor(_fake(np.ones((k, n), np.int8)),
                         _fake(np.ones((1, n), np.float32)))


@pytest.mark.parametrize("entry", ["kernel", "core", "dense", "dense_use_int8"])
def test_int8_matmul_cuda_tensor_raises_without_toolchain(entry, no_toolchain,
                                                          monkeypatch):
    """Every int8 entry point on a CUDA tensor goes to the kernel and, with
    no nvcc, raises; the plain version is never taken."""
    _forbid(monkeypatch, i8_ops, "int8_matmul_ref")
    _forbid(monkeypatch, i8_ops, "int8_matmul_2d_ref")
    _forbid(monkeypatch, quant, "int8_accumulate")
    x = _fake(np.ones((2, 3, 64), np.float32))
    wq = _fake_qtensor()
    call = {"kernel": lambda: i8_ops.int8_matmul(x, wq),
            "core": lambda: quant.int8_matmul(x, wq),
            "dense": lambda: quant.dense_maybe_quant(x, wq),
            "dense_use_int8": lambda: quant.dense_maybe_quant(
                x, _fake(np.ones((64, 32), np.float32)), use_int8=True)}[entry]
    before = i8_ops.int8_matmul.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        call()
    assert i8_ops.int8_matmul.launches == before


@pytest.mark.parametrize("bad", [
    "x_int", "w_float", "scale_f64", "w_3d", "k_mismatch", "scale_flat",
    "w_strided", "k_too_large"])
def test_int8_matmul_card_checks_raise(bad, no_toolchain, monkeypatch):
    """What the kernel does not take is refused before any launch."""
    _forbid(monkeypatch, i8_ops, "int8_matmul_ref")
    x = np.ones((4, 64), np.float32)
    w = np.ones((64, 32), np.int8)
    ws = np.ones((1, 32), np.float32)
    if bad == "x_int":
        x = x.astype(np.int32)
    elif bad == "w_float":
        w = w.astype(np.float32)
    elif bad == "scale_f64":
        ws = ws.astype(np.float64)
    elif bad == "w_3d":
        w = w[None]
    elif bad == "k_mismatch":
        w = np.ones((48, 32), np.int8)
    elif bad == "scale_flat":
        ws = ws[0]
    elif bad == "w_strided":       # neither row-major nor K-major
        w = np.ones((64, 64), np.int8)[:, ::2]
    elif bad == "k_too_large":
        x = np.ones((1, i8_ops.MAX_K + 1), np.float32)
        w = np.ones((i8_ops.MAX_K + 1, 1), np.int8)
        ws = np.ones((1, 1), np.float32)
    wq = quant.QTensor(_fake(torch.from_numpy(w)), _fake(ws))
    before = i8_ops.int8_matmul.launches
    with pytest.raises((TypeError, ValueError)):
        i8_ops.int8_matmul(_fake(x), wq)
    assert i8_ops.int8_matmul.launches == before


def test_int8_matmul_k_limit_is_the_int32_boundary(no_toolchain, monkeypatch):
    """K up to MAX_K keeps |acc| ≤ K·2^14 inside int32 (operands of −128)
    and reaches the build; one more is refused before any launch."""
    assert i8_ops.MAX_K * 2**14 <= 2**31 - 1 < (i8_ops.MAX_K + 1) * 2**14
    _forbid(monkeypatch, i8_ops, "int8_matmul_2d_ref")
    xs = _fake(np.ones((), np.float32))
    ws = _fake(np.ones((1, 1), np.float32))
    for k, err in ((i8_ops.MAX_K, RuntimeError), (i8_ops.MAX_K + 1, ValueError)):
        xv = _fake(np.full((1, k), -128, np.int8))
        wv = _fake(np.full((k, 1), -128, np.int8))
        before = i8_ops.int8_matmul.launches
        with pytest.raises(err, match="nvcc" if err is RuntimeError else "K ≤"):
            i8_ops.int8_matmul_2d(xv, wv, xs, ws)
        assert i8_ops.int8_matmul.launches == before


def test_int8_matmul_2d_checks_raise(no_toolchain, monkeypatch):
    _forbid(monkeypatch, i8_ops, "int8_matmul_2d_ref")
    xv = _fake(np.ones((4, 64), np.int8))
    wv = _fake(np.ones((64, 32), np.int8))
    ws = _fake(np.ones((1, 32), np.float32))
    with pytest.raises(ValueError, match="x_scale"):
        i8_ops.int8_matmul_2d(xv, wv, _fake(np.ones(2, np.float32)), ws)
    with pytest.raises(TypeError, match="int8 values"):
        i8_ops.int8_matmul_2d(_fake(np.ones((4, 64), np.float32)), wv,
                              _fake(np.ones((), np.float32)), ws)


def test_int8_wrappers_refuse_other_devices(monkeypatch):
    _forbid(monkeypatch, i8_ops, "int8_matmul_ref")
    _forbid(monkeypatch, i8_ops, "int8_matmul_2d_ref")
    m = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device="meta")  # noqa: E731
    wq = quant.QTensor(m(8, 4, dt=torch.int8), m(1, 4))
    for call in (lambda: i8_ops.int8_matmul(m(2, 8), wq),
                 lambda: quant.int8_matmul(m(2, 8), wq),
                 lambda: i8_ops.int8_matmul_2d(m(2, 8, dt=torch.int8),
                                               wq.values, m(1), wq.scale)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
