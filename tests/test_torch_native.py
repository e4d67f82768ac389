"""The port's native CSV parser (kafka_ps_tpu_torch/native): its build
into the port's own build directory, parse equivalence with the Python
parsers of both packages, CSR integrity, the stream's parser selection,
and concurrent first use from several processes.

The cases of tests/test_native.py run here against the port's parser.
Every test that builds or loads the library skips only where no C++
compiler is on PATH.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from kafka_ps_tpu.data import stream as jstream
from kafka_ps_tpu_torch import native
from kafka_ps_tpu_torch.data import stream
from kafka_ps_tpu_torch.data.synth import generate, write_csv
from kafka_ps_tpu_torch.native import binding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cxx():
    """Decided per test, never at import: skip without a compiler."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler (g++) on PATH")


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    x, y = generate(120, 24, 4, noise=1.0, sparsity=0.6, seed=5)
    path = tmp_path_factory.mktemp("native") / "train.csv"
    write_csv(str(path), x, y)
    return str(path)


# -- the cases of tests/test_native.py ------------------------------------------


def test_native_matches_python_parser(cxx, csv_path):
    native_rows = list(stream.iter_csv_rows(csv_path, use_native=True))
    python_rows = list(stream.iter_csv_rows(csv_path, use_native=False))
    assert len(native_rows) == len(python_rows) == 120
    for (nf, nl), (pf, pl) in zip(native_rows, python_rows):
        assert nl == pl
        assert set(nf) == set(pf)
        for k in nf:
            assert nf[k] == pytest.approx(pf[k], rel=1e-6)


def test_native_dense_roundtrip(cxx, csv_path):
    parsed = native.parse_csv(csv_path)
    x, y = parsed.to_dense()
    x_ref, y_ref = stream.load_csv_dataset(csv_path)
    np.testing.assert_allclose(x, x_ref, rtol=1e-6)
    np.testing.assert_array_equal(y, y_ref)


def test_native_csr_offsets_monotone(cxx, csv_path):
    parsed = native.parse_csv(csv_path)
    off = parsed.row_offsets
    assert off[0] == 0 and off[-1] == len(parsed.keys)
    assert (np.diff(off) >= 0).all()
    assert parsed.num_features == 24


def test_native_rejects_feature_mismatch(cxx, csv_path):
    with pytest.raises(ValueError, match="columns"):
        list(stream.iter_csv_rows(csv_path, num_features=7,
                                  use_native=True))


def test_native_handles_headerless_and_crlf(cxx, tmp_path):
    path = tmp_path / "raw.csv"
    path.write_bytes(b"1.5,0,2\r\n0,3,1\r\n")
    parsed = native.parse_csv(str(path), has_header=False)
    assert parsed.num_rows == 2
    assert parsed.row(0) == ({0: 1.5}, 2)
    assert parsed.row(1) == ({1: 3.0}, 1)


def test_native_rejects_malformed(cxx, tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("h1,h2\n1.0,junk!\n")
    with pytest.raises(RuntimeError, match="native parse failed"):
        native.parse_csv(str(path))


def test_python_fallback_forced(csv_path):
    rows = list(stream.iter_csv_rows(csv_path, use_native=False))
    assert len(rows) == 120


def test_auto_falls_back_on_strict_native_failure(cxx, tmp_path):
    # whitespace-only line: Python skips it, the C parser rejects the
    # file — auto mode falls back, forced native raises
    path = tmp_path / "loose.csv"
    path.write_text("h1,h2\n1.0,2\n   \n0.5,1\n")
    rows = list(stream.iter_csv_rows(str(path)))          # auto
    assert [lab for _, lab in rows] == [2, 1]
    with pytest.raises(RuntimeError, match="native parse failed"):
        list(stream.iter_csv_rows(str(path), use_native=True))


def test_header_only_csv_yields_nothing(cxx, tmp_path):
    path = tmp_path / "empty.csv"
    path.write_text("h1,h2,h3\n")
    assert list(stream.iter_csv_rows(str(path), num_features=24)) == []


def test_producer_paces_with_native(cxx, csv_path):
    """The paced producer runs unchanged over the native parse path."""
    got = []
    producer = stream.CsvStreamProducer(
        csv_path, num_workers=2,
        sink=lambda w, f, lab: got.append((w, lab)),
        time_per_event_ms=0.0, prefill_per_worker=4)
    producer.run()
    assert len(got) == 120
    assert {w for w, _ in got} == {0, 1}
    assert producer.parser == "native" and producer.parse_s > 0


# -- against the JAX package's Python parser ------------------------------------


@pytest.mark.parametrize("use_native", [None, True, False])
def test_rows_equal_the_jax_python_parser(cxx, csv_path, use_native):
    """Row for row the same keys, labels and float32 values as
    kafka_ps_tpu's Python parser (use_native=False there, which never
    touches that package's own native build)."""
    ours = list(stream.iter_csv_rows(csv_path, num_features=24,
                                     use_native=use_native))
    ref = list(jstream.iter_csv_rows(csv_path, num_features=24,
                                     use_native=False))
    assert len(ours) == len(ref) == 120
    for (of, ol), (rf, rl) in zip(ours, ref):
        assert ol == rl and list(of) == list(rf)
        assert (np.float32(list(of.values()))
                == np.float32(list(rf.values()))).all()


def test_width_mismatch_message_is_the_reference_one(cxx, csv_path):
    for use_native in (True, False):
        with pytest.raises(ValueError) as ours:
            list(stream.iter_csv_rows(csv_path, num_features=7,
                                      use_native=use_native))
        with pytest.raises(ValueError) as ref:
            list(jstream.iter_csv_rows(csv_path, num_features=7,
                                       use_native=False))
        if not use_native:
            assert str(ours.value) == str(ref.value)
        else:
            assert str(ours.value) == "rows have 25 columns, expected 8"


# -- the build --------------------------------------------------------------------


def test_library_is_built_into_the_ports_build_directory(cxx):
    assert native.is_available()
    path = binding.library_path()
    assert os.path.dirname(path) == os.path.join(
        REPO, "kafka_ps_tpu_torch", "_build")
    assert os.path.basename(path).startswith("libkpscsv-")
    assert os.path.exists(path)
    assert binding._load()._name == path


def test_concurrent_first_use_all_load(cxx, tmp_path):
    """Six processes build the parser into one fresh build directory at
    once: one compiles under the lock, every process loads a whole
    library and parses."""
    build = tmp_path / "build"
    csv = tmp_path / "t.csv"
    csv.write_text("a,b,c\n1.5,0,2\n0,3,1\n")
    code = (
        "import sys\n"
        "from kafka_ps_tpu_torch.native import binding\n"
        "binding.BUILD_DIR = sys.argv[1]\n"
        "assert binding.is_available()\n"
        "p = binding.parse_csv(sys.argv[2])\n"
        "assert p.row(0) == ({0: 1.5}, 2) and p.row(1) == ({1: 3.0}, 1)\n"
        "print('loaded', binding._load()._name)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build),
                               str(csv)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.startswith("loaded ")
    libs = [n for n in os.listdir(build) if n.endswith(".so")]
    assert len(libs) == 1 and not [n for n in os.listdir(build)
                                   if n.endswith(".tmp")]


def test_failed_build_raises_with_compiler_output(cxx, tmp_path,
                                                  monkeypatch):
    bad = tmp_path / "csvparse.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(binding, "SOURCE", str(bad))
    monkeypatch.setattr(binding, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(binding, "_lib", None)
    for _ in range(2):       # no flag turns the parser off after a failure
        with pytest.raises(RuntimeError, match="(?s)build failed.*error: "):
            native.is_available()
    with pytest.raises(RuntimeError, match="build failed"):
        list(stream.iter_csv_rows(str(bad)))


def test_without_a_compiler_the_python_parser_runs(csv_path, tmp_path,
                                                   monkeypatch):
    monkeypatch.setattr(binding, "BUILD_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding.shutil, "which", lambda name: None)
    assert not native.is_available()
    assert len(list(stream.iter_csv_rows(csv_path))) == 120
    with pytest.raises(RuntimeError, match="requested but unavailable"):
        list(stream.iter_csv_rows(csv_path, use_native=True))
    producer = stream.CsvStreamProducer(
        csv_path, num_workers=2, sink=lambda w, f, lab: None,
        time_per_event_ms=0.0)
    producer.run()
    assert producer.parser == "python" and producer.rows_sent == 120


def test_producer_reports_the_forced_python_parser(csv_path):
    producer = stream.CsvStreamProducer(
        csv_path, num_workers=3, sink=lambda w, f, lab: None,
        time_per_event_ms=0.0, use_native=False)
    producer.run()
    assert producer.parser == "python" and producer.rows_sent == 120
