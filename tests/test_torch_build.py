"""The port's CUDA build names each library by what it is compiled from."""
from repro_torch.kernels import _build


def _names(monkeypatch, tmp_path, files):
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return _build._target("a").name


def test_target_follows_source_flags_and_headers(monkeypatch, tmp_path):
    base = _names(monkeypatch, tmp_path,
                  {"a.cu": '#include "h.cuh"\n', "h.cuh": "// one\n"})
    assert base.startswith("liba-") and base.endswith(".so")
    assert _build._target("a").name == base  # stable for the same files
    header = _names(monkeypatch, tmp_path, {"h.cuh": "// two\n"})
    assert header != base
    source = _names(monkeypatch, tmp_path, {"a.cu": '#include "h.cuh"\n\n'})
    assert source not in (base, header)
    monkeypatch.setattr(_build, "nvcc_flags", lambda name: ("-O2",))
    assert _build._target("a").name != source


def test_allocator_sources_build_without_fma_contraction():
    for name in ("gnep_iter", "gnep_sweep"):
        assert "-fmad=false" in _build.nvcc_flags(name)
    for name in ("flash_attention", "wkv6"):
        assert "-fmad=false" not in _build.nvcc_flags(name)
