"""fontrx_torch's roofline probe (K13) against the JAX package's, on the CPU.

- The JAX probe, ``tools/tpu_probes/tpu_roofline.py``, loaded by path and
  left unedited: ``main()`` runs with only the loaded module's own names
  patched (``jax.jit`` as the identity, ``pl.pallas_call`` in interpret mode
  and recording each output, ``_timed`` running once, ``bench_hbm`` doing
  nothing). Its four outputs at ``[16, 512, 128]`` equal the port's plain
  version (``roofline_ref``) bit for bit.
- The plain version equals a NumPy model of each mix on inputs that take
  both sides of the select, negative values and int16 wrap-around.
- The wrapper sends a CPU tensor to the plain version and refuses what the
  kernel does not take.
- The SASS check and the issue bound of ``fontrx_torch.bench.roofline`` on
  SASS text: a folded or contracted chain fails the model; the loop is
  found; each instruction lands on its pipe.

The module imports JAX only inside the fixture that runs the JAX probe, so
the card's tests also run where there is none:
``python -m pytest --noconftest -m requires_cuda tests/test_torch_roofline.py``.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from fontrx_torch.bench import roofline as probe
from fontrx_torch.kernels import _build, roofline, roofline_ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
MIXES = list(roofline_ref.MIXES)
# the JAX probe's outputs (every element alike): float32 bits, or the integer
KNOWN = {"f32_mul_add": 1065362440, "i32_add": 3073, "i16_add": 3073,
         "f32_cmp_select_add": 1065354248}
f32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread: with one per core, parallel test workers spin
    against each other (``tests/test_torch_sharding.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Proxy:
    """A module's names, with some replaced."""

    def __init__(self, real, **names):
        self._real = real
        self.__dict__.update(names)

    def __getattr__(self, name):
        return getattr(self._real, name)


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX probe's four outputs, in the order ``main()`` runs the mixes
    (``tpu_roofline.py:122-138``), as NumPy arrays."""
    spec = importlib.util.spec_from_file_location(
        "tpu_roofline_probe", ROOT / "tools" / "tpu_probes" / "tpu_roofline.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    outputs = []

    def pallas_call(*args, **kwargs):
        call = pallas.pallas_call(*args, interpret=True, **kwargs)

        def run(*operands):
            out = call(*operands)
            outputs.append(np.asarray(out))
            return out

        return run

    pallas = m.pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(m, "jax", _Proxy(m.jax, jit=lambda f: f))
        mp.setattr(m, "pl", _Proxy(pallas, pallas_call=pallas_call))
        mp.setattr(m, "_timed", lambda run, **_: (run(m.jnp.float32(0)), 1.0)[1])
        mp.setattr(m, "bench_hbm", lambda: None)
        m.main()
    assert len(outputs) == len(MIXES)
    return dict(zip(MIXES, outputs))


def as_bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("mix", MIXES)
def test_plain_version_equals_jax(jax_outputs, mix):
    want = jax_outputs[mix]
    x = roofline_ref.initial(mix, probe.SHAPE)
    got = roofline_ref.elementwise(mix, x, probe.ITERS).numpy()
    assert got.shape == want.shape == probe.SHAPE and got.dtype == want.dtype
    np.testing.assert_array_equal(as_bits(got), as_bits(want))
    assert set(np.unique(as_bits(got)).tolist()) == {KNOWN[mix]}


def numpy_model(mix, x, iters):
    """Each mix in NumPy, every product and sum rounded to the mix's type."""
    y = x.copy()
    for _ in range(iters):
        if mix == "f32_mul_add":
            y = (y * f32(1.000001)).astype(f32) + f32(1e-7)
        elif mix == "i32_add":
            y = y + np.int32(3)
        elif mix == "i16_add":
            y = y + np.int16(3)
        else:
            y = y + np.where(y >= f32(0.5), f32(1e-7), f32(-1e-7))
    return y


def random_input(mix, rng, n=4096):
    if mix.startswith("f32"):
        # both sides of the select at 0.5, a few values that cross it
        edge = [0.5, 0.5 - 3e-7, 0.5 + 3e-7]
        return np.concatenate([rng.uniform(-2, 2, n - 3), edge]).astype(f32)
    # the largest values wrap around
    if mix == "i32_add":
        return np.concatenate([rng.integers(-2**31, 2**31, n - 1), [2**31 - 5]]).astype(np.int32)
    return np.concatenate([rng.integers(-2**15, 2**15, n - 1), [2**15 - 5]]).astype(np.int16)


@pytest.mark.parametrize("iters", [1, 32, 100])
@pytest.mark.parametrize("mix", MIXES)
def test_plain_version_equals_numpy_model(mix, iters):
    x = random_input(mix, np.random.default_rng(iters))
    with np.errstate(over="ignore"):
        want = numpy_model(mix, x, iters)
    got = roofline_ref.elementwise(mix, torch.from_numpy(x), iters).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(as_bits(got), as_bits(want))


@pytest.mark.parametrize("mix", MIXES)
def test_wrapper_sends_a_cpu_tensor_to_the_plain_version(monkeypatch, mix):
    def no_kernel(name):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(_build, "load", no_kernel)
    x = roofline_ref.initial(mix, (3, 5))
    before = roofline.launches
    got = roofline.elementwise(mix, x, 64)
    assert roofline.launches == before
    assert torch.equal(got, roofline_ref.elementwise(mix, x, 64))
    assert torch.equal(x, roofline_ref.initial(mix, (3, 5)))  # the input is left as it was


@pytest.mark.parametrize("mix,dtype,iters,error", [
    ("f64_add", torch.float32, 32, ValueError),
    ("i32_add", torch.float32, 32, TypeError),
    ("i16_add", torch.int32, 32, TypeError),
    ("f32_mul_add", torch.float32, -32, ValueError),
])
def test_wrapper_refuses(mix, dtype, iters, error):
    with pytest.raises(error):
        roofline.elementwise(mix, torch.zeros(4, dtype=dtype), iters)


# --- the SASS check ---------------------------------------------------------

def sass_function(name, body, *, loops=1):
    """``cuobjdump -sass`` text of one kernel whose loop (``loops`` of them)
    runs ``body`` beside the counter add, compare and backward branch that
    nvcc emits."""
    lines = [f"\t\tFunction : {name}", '\t.headerflags\t@"EF_CUDA_SM90"',
             "        /*0000*/                   LDC R1, c[0x0][0x28] ;"
             "                         /* 0x00000a00ff017b82 */",
             " " * 82 + "/* 0x000e220000000800 */",
             "        /*0010*/               @P0 EXIT ;",
             "        /*0020*/              @!P0 BRA 0xff00 ;"]
    addr = 0x30
    for _ in range(loops):
        start = addr
        for ins in ["UIADD3 UR4, UR4, 0x1, URZ", *body[:1], "ISETP.LE.AND P1, PT, R0, UR4, PT",
                    *body[1:]]:
            lines.append(f"        /*{addr:04x}*/                   {ins} ;")
            addr += 0x10
        lines.append(f"        /*{addr:04x}*/              @!P1 BRA 0x{start:x} ;")
        addr += 0x10
    lines += [f"        /*{addr:04x}*/                   STG.E desc[UR6][R2.64], R7 ;",
              f"        /*{addr + 0x10:04x}*/                   EXIT ;",
              f"        /*{addr + 0x20:04x}*/                   BRA 0x{addr + 0x20:x};",
              "\t\t.........."]
    return "\n".join(lines) + "\n"


MUL_ADD = ["FMUL R7, R7, 1.0000009536743164062", "FADD R7, R7, 1.0000000116860974231e-07"] * 8
PREDICATED = ["@P0 VIADD R7, R7, 0x3", "@P0 IADD3 R7, R7, 0x3, RZ", "@P0 VIADD R7, R7, 0x3",
              "@P0 VIADD R7, R7, 0x3"] * 2
CMP = ["FSETP.GE.AND P0, PT, R0, 0.5, PT", "FSEL R3, R2, -1.0000000116860974231e-07, P0",
       "FADD R3, R0, R3"] * 8


def test_parse_loops_finds_the_loop():
    text = sass_function("roofline_f32_mul_add", MUL_ADD) + sass_function(
        "roofline_f32_cmp_select_add", CMP)
    loops = probe.parse_loops(text)
    assert sorted(loops) == ["roofline_f32_cmp_select_add", "roofline_f32_mul_add"]
    body = loops["roofline_f32_mul_add"]
    assert body[0][0] == "UIADD3" and body[-1][0] == "BRA" and len(body) == 16 + 3
    counts = probe.loop_counts(body)
    assert (counts["FMUL"], counts["FADD"], counts["FFMA"]) == (8, 8, 0)
    probe.check_model("f32_mul_add", counts, 8)
    assert probe.pipe_counts(body) == {"dispatch": 19, "fp32": 16, "alu": 1}
    cmp = loops["roofline_f32_cmp_select_add"]
    probe.check_model("f32_cmp_select_add", probe.loop_counts(cmp), 8)
    assert probe.pipe_counts(cmp) == {"dispatch": 27, "alu": 17, "fp32": 8}


def test_predicated_adds_pass_and_split_over_two_pipes():
    body = probe.parse_loops(sass_function("roofline_i32_add", PREDICATED))["roofline_i32_add"]
    counts = probe.loop_counts(body)
    assert counts["add3"] == 8
    probe.check_model("i32_add", counts, 8)
    probe.check_model("i16_add", counts, 8)
    assert probe.pipe_counts(body) == {"dispatch": 11, "imad": 6, "alu": 3}


@pytest.mark.parametrize("mix,body", [
    # ptxas's fold of eight asm adds of 3 (nvcc 12.9, sm_90a)
    ("i32_add", ["VIADD R7, R7, 0x18"]),
    # pairs fused into a multiply-add of a register addend
    ("i32_add", ["IMAD R7, R2, 0x2, R7"] * 4),
    ("f32_mul_add", ["FFMA R7, R7, 1.0000009536743164062, R2"] * 8),
    ("f32_mul_add", MUL_ADD[:-2] + ["FFMA R7, R7, 1.0000009536743164062, R2"]),
    ("f32_cmp_select_add", CMP[:-2]),
])
def test_a_folded_or_contracted_chain_fails_the_model(mix, body):
    loop = probe.parse_loops(sass_function("k", body))["k"]
    with pytest.raises(RuntimeError, match=mix):
        probe.check_model(mix, probe.loop_counts(loop), 8)


@pytest.mark.parametrize("loops", [0, 2])
def test_parse_loops_needs_exactly_one_loop(loops):
    with pytest.raises(RuntimeError, match=f"{loops} loops"):
        probe.parse_loops(sass_function("k", MUL_ADD, loops=loops))


def test_pipe_counts_refuses_an_unplaced_opcode():
    with pytest.raises(RuntimeError, match="HADD2"):
        probe.pipe_counts([("HADD2", "R1, R1, R2"), ("BRA", "0x30")])


def test_issue_bound():
    pipes = {"dispatch": 67, "fp32": 64, "alu": 1}
    ms, pipe = probe.issue_bound_ms(pipes, threads=2**20, trips=32, sms=132, clock_hz=1.98e9)
    assert pipe == "dispatch"
    assert ms == pytest.approx(67 * 32 * 2**20 / (132 * 128 * 1.98e9) * 1e3, rel=1e-12)
    ms, pipe = probe.issue_bound_ms({"dispatch": 11, "imad": 6, "alu": 3}, threads=1, trips=1,
                                    sms=1, clock_hz=1.0)
    assert (pipe, ms) == ("imad", pytest.approx(6 / 64 * 1e3))


def test_sass_check_without_cuobjdump_raises(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    monkeypatch.setattr(probe.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="cuobjdump not found"):
        probe.sass_loops("libroofline.so")


def test_report_names_the_card_on_every_line(capsys):
    mix = dict(ms=0.07, ops=2**31, tops=30.0, issue_bound_ms=0.064, issue_bound_pipe="fp32",
               issue_bound_tops=33.5, of_datasheet=0.45, sass={"FMUL": 32}, pipes={"fp32": 64})
    result = dict(card=dict(name_power="NVIDIA H100 80GB HBM3, 700.00 W", sms=132,
                            max_sm_clock_mhz=1980.0),
                  shape=list(probe.SHAPE), iters=probe.ITERS, unroll=32,
                  mixes={m: mix for m in MIXES},
                  hbm=dict(ms=0.2, bytes=2 * probe.HBM_BYTES, gb_per_s=2684.0, of_datasheet=0.8),
                  ascii256=dict(ops=1, bytes=1, datasheet_bound_ms=1.0, datasheet_bound_by="bytes",
                                measured_bound_ms=1.0, measured_bound_by="bytes"))
    probe.report(result)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 + len(MIXES) + 2
    assert all("[NVIDIA H100 80GB HBM3, 700.00 W]" in line for line in lines)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mix", MIXES)
def test_kernel_equals_plain_version_on_card(cuda, mix):
    x = roofline_ref.initial(mix, probe.SHAPE, cuda)
    before = roofline.launches
    got = roofline.elementwise(mix, x, probe.ITERS)
    torch.cuda.synchronize()
    assert roofline.launches == before + 1
    want = roofline_ref.elementwise(mix, x, probe.ITERS)
    assert torch.equal(as_bits_torch(got), as_bits_torch(want))
    assert int(as_bits_torch(got).flatten()[0]) == KNOWN[mix]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mix", MIXES)
def test_kernel_equals_plain_version_on_random_inputs(cuda, mix):
    # 1000 elements: a partial last block
    x = torch.from_numpy(random_input(mix, np.random.default_rng(7), n=1000)).to(cuda)
    got = roofline.elementwise(mix, x, 96)
    assert torch.equal(as_bits_torch(got), as_bits_torch(roofline_ref.elementwise(mix, x, 96)))


@pytest.mark.requires_cuda
def test_kernel_refuses_iters_off_its_unroll(cuda):
    x = roofline_ref.initial("i32_add", (4,), cuda)
    assert roofline.unroll() == 32
    with pytest.raises(RuntimeError, match="launch failed"):
        roofline.elementwise("i32_add", x, roofline.unroll() + 8)


def as_bits_torch(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t
