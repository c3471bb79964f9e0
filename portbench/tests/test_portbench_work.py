"""The yardstick's arithmetic on the CPU: exact counts at small shapes, the
kernel-name map against the CUDA sources, the launch-shape map against the
port's launch sites, and the reduction of a trace."""

import pathlib
import re
from types import SimpleNamespace

import pytest
import torch

from portbench import devtrace, work

ROOT = pathlib.Path(__file__).resolve().parents[2]
CSRC = ROOT / "gogp_torch" / "csrc"
B = work.BLOCK


@pytest.mark.parametrize("key, shape, want", [
    ("tril_inv_tile", (4, B, B), (4 * 2 * 4 * B * B, 4 * B**3 / 3)),
    ("chol_inv_tile", (8, B, B), (8 * 4 * 3 * B * B, 8 * 2 * B**3 / 3)),
    ("chol_inv_tile", (B, B), (4 * 3 * B * B, 2 * B**3 / 3)),
    ("chol_tile", (B, B), (4 * 2 * B * B, B**3 / 3)),
    ("fused_cholesky_invs", (1024, 1024),
     (4 * (1024 * (1024 + B) / 2 + 1024 * 1024 + 1024 * B), 1024**3 / 3 + 8 * B**3 / 3)),
    ("trsv2d_lower", (1024, 1024),
     (4 * (1024 * (1024 - B) / 2 + 1024 * B + 2 * 1024), 1024 * (1024 - B) + 2 * 1024 * B)),
    ("trsv2d_lower", (8, 1024, 1024),
     (8 * 4 * (1024 * (1024 - B) / 2 + 1024 * B + 2 * 1024), 8 * (1024 * (1024 - B) + 2 * 1024 * B))),
    ("fused_gp_linv", (64, 44, 44), (4 * 64 * (44 * 45 / 2 + 44 * 44), 64 * 2 * 44**3 / 3)),
])
def test_work_counts(key, shape, want):
    assert work.work(key, shape) == pytest.approx(want, rel=1e-15)


def test_bound_takes_the_larger_time():
    # K4 at n = 16384 is bound by its bytes, K1 at 4096 by its operations
    t, by = work.bound_s("trsv2d_lower", (16384, 16384))
    assert by == "bytes" and t == pytest.approx(work.work("trsv2d_lower", (16384, 16384))[0] / 3.35e12)
    t, by = work.bound_s("fused_cholesky_invs", (4096, 4096))
    assert by == "operations" and t == pytest.approx((4096**3 / 3 + 32 * B**3 / 3) / 67e12)


def test_vg_flops():
    assert work.vg_flops(1, 1024, 3) == 1024**3 + 20 * 1024**2
    assert work.vg_flops(8, 1024, 3) == 8 * work.vg_flops(1, 1024, 3)


def _global_symbols() -> set[str]:
    names = set()
    for src in CSRC.glob("*.cu"):
        text = src.read_text()
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", text))
    return names


def test_kernel_map_matches_the_sources():
    assert _global_symbols() == set(work.KERNEL_OF_SYMBOL)


def test_entry_map_covers_every_launch():
    from gogp_torch.ops import _build

    text = "".join((ROOT / "gogp_torch" / "ops" / f).read_text() for f in ("cholesky_blocked.py", "fused_gp.py"))
    launched = {n for n in re.findall(r'"(gogp_\w+)"', text) if n in _build.SIGNATURES}
    assert launched <= set(work.ENTRY_SHAPES)
    for name, (kernel, key, _) in work.ENTRY_SHAPES.items():
        assert name in _build.SIGNATURES and kernel in work.KERNEL_OF_SYMBOL.values()
        work.work(key, (2, B, B))


@pytest.mark.parametrize("entry, args, want", [
    ("gogp_fused_cholesky_invs", (0, 0, 0, 0, 4096, B), (4096, 4096)),
    ("gogp_chol_inv_tiles", (0, 16384, 0, 0, 16384, 0, 0, B, 0, B, 8), (8, B, B)),
    ("gogp_tril_inv_tiles", (0, 0, 64, B), (64, B, B)),
    ("gogp_trsv2d_lower_batched", (0, 0, 0, 0, 0, 0, 1024, B, 8), (8, 1024, 1024)),
    ("gogp_trsv2d_lower_t_batched", (0, 0, 0, 0, 0, 0, 16384, B, 1), (1, 16384, 16384)),
    ("gogp_trsv_lower", (0, 0, 0, 0, 0, 2048, B), (2048, 2048)),
    ("gogp_chol_tile", (0, B, 0, B, B), (B, B)),
    ("gogp_fused_gp_linv", (0, 0, 64, 44), (64, 44, 44)),
])
def test_entry_shapes(entry, args, want):
    from gogp_torch.ops import _build

    assert len(args) == len(_build.SIGNATURES[entry]) - 1  # all but the stream
    assert work.ENTRY_SHAPES[entry][2](args) == want


@pytest.mark.parametrize("name, want", [
    ("(anonymous namespace)::fused_chol_kernel(float const*, float*, float*, int*, int)", "K1"),
    ("void chol_inv_tile_kernel<128>(float const*, int, long long, float*, int, long long, float*, int, long long)",
     "K2"),
    ("void trsv2d_kernel<true>(float const*, float const*, float const*, float*, int, int, Workspace)", "K4"),
    ("void (anonymous namespace)::tril_inv_tiles_kernel(float const*, float*, int, bool)", "K5"),
    ("void linv_warp_kernel<64>(float const*, float*, int, int, bool)", "K7"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>(cutlass_80_simt_sgemm::Params)", None),
    ("void potrf_cta_lower_batch<float, float, 16>(int, int, int, float**, unsigned long, int*)", None),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::MulFunctor<float> >(int)", None),
])
def test_kernel_of(name, want):
    assert devtrace.kernel_of(name) == want


def test_torch_and_copies():
    assert devtrace.is_torch("void at::native::reduce_kernel<512, 1>(int)")
    assert devtrace.is_torch("Memcpy DtoH (Device -> Pinned)")
    assert not devtrace.is_torch("void trsm_right_kernel<int, float, 256>(cublasTrsmParams<int, float>)")


def test_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 12)]
    assert devtrace.union_length(spans) == 3 + 1 + 4
    assert devtrace.idle_gaps(spans, -1, 10) == [(-1, 0), (3, 5), (6, 8)]
    assert devtrace.union_length([]) == 0


def _event(name, start, end, device=True, annotation=False):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_reduce():
    events = [
        _event("portbench.traced_window", 0, 100, annotation=True),  # on the device's timeline, not work
        _event("void chol_inv_tile_kernel<128>(float const*)", 10, 20),
        _event("void chol_inv_tile_kernel<128>(float const*)", 20, 30),
        _event("void cutlass::Kernel2<sgemm>(Params)", 25, 40),
        _event("void at::native::vectorized_elementwise_kernel<4>(int)", 70, 75),
        _event("Memcpy DtoH (Device -> Pageable)", 75, 80),
    ]
    launches = [("K2", "chol_inv_tile", (1, B, B))] * 2
    t = devtrace.reduce(events, 100e-6, launches, vg_calls=2, steps=2, vg_flops=1.0, host_vg_s=0.5)
    assert t.window_s == 100e-6
    assert t.busy_s == pytest.approx(40e-6)  # 10-40 and 70-80
    assert t.device_launches == 4
    assert t.library_s == pytest.approx(15e-6)
    k2 = t.kernels["K2"]
    assert (k2["events"], k2["launches"]) == (2, 2)
    assert k2["device_s"] == pytest.approx(20e-6)
    assert k2["bound_s"] == pytest.approx(2 * work.bound_s("chol_inv_tile", (1, B, B))[0])
    assert t.device_ops[0][0].startswith("void chol_inv_tile_kernel")


def test_idle_by_host():
    events = [
        _event("portbench.traced_window", 0, 100, device=False),
        _event("portbench.traced_window", 0, 100, annotation=True),
        _event("aten::item", 40, 60, device=False),
        _event("void chol_inv_tile_kernel<128>(float const*)", 10, 40),
        _event("Memcpy DtoH (Device -> Pageable)", 70, 80),
    ]
    gaps = dict(devtrace.idle_by_host(events))
    assert gaps["aten::item"] == pytest.approx(30e-6)  # 40-70, the host reading a value back
    assert gaps["portbench.traced_window"] == pytest.approx(30e-6)  # 0-10 and 80-100
