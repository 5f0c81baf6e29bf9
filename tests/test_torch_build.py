"""The kernel build (ops/cuda/build.py) against a stand-in nvcc.

The CPU has no CUDA toolkit, so a small script takes nvcc's place: it
records its arguments and writes the file named by ``-o``. The build must
compile every ``csrc/*.cu`` file in its own nvcc process, link the objects
into one library, and report a failing compile with its output.
"""

import json
import sys

import pytest

from madrona_learn_tpu_torch.ops.cuda import build

FAKE_NVCC = """#!{python}
import json, sys
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(json.dumps(args) + "\\n")
src = [a for a in args if a.endswith(".cu")]
if src and src[0].endswith({fail!r}):
    print("error: stand-in failure in " + src[0])
    sys.exit(2)
with open(args[args.index("-o") + 1], "w") as f:
    f.write("built")
"""


def _fake_nvcc(tmp_path, monkeypatch, fail="never"):
    log = tmp_path / "calls.jsonl"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log),
                                     fail=fail))
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return log


def _calls(log):
    return [json.loads(line) for line in log.read_text().splitlines()]


def test_build_compiles_each_source_then_links_once(tmp_path, monkeypatch):
    log = _fake_nvcc(tmp_path, monkeypatch)
    lib = build.build()
    assert lib.name == build.LIB_NAME and lib.read_text() == "built"
    calls = _calls(log)
    sources = sorted(s.name for s in build.CSRC_DIR.glob("*.cu"))
    assert {"gru.cu", "layer_norm.cu", "lstm.cu"} <= set(sources)
    compiles, links = calls[:-1], calls[-1]
    assert sorted(c[-1].rsplit("/", 1)[-1] for c in compiles) == sources
    assert all("-c" in c and "-shared" not in c for c in compiles)
    assert "-shared" in links and "-c" not in links
    # nvcc takes an input's type from its suffix.
    objects = [a for a in links if a.endswith(".o")]
    assert len(objects) == len(sources)
    assert sorted(c[c.index("-o") + 1] for c in compiles) == sorted(objects)
    # The objects are removed once linked; a second call reuses the library.
    assert sorted(p.name for p in lib.parent.iterdir()) == [
        "build.log", build.LIB_NAME]
    assert build.build() == lib
    assert len(_calls(log)) == len(calls)


def test_build_reports_a_failing_source(tmp_path, monkeypatch):
    log = _fake_nvcc(tmp_path, monkeypatch, fail="gru.cu")
    with pytest.raises(RuntimeError, match="stand-in failure in .*gru.cu"):
        build.build()
    # Every source was compiled, and nothing was linked.
    calls = _calls(log)
    assert all("-c" in c for c in calls)
    assert not list((tmp_path / "_build").glob(f"*/{build.LIB_NAME}"))
