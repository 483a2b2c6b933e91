"""The kernel build's bookkeeping, on the CPU (nothing is compiled here).

Every library in ``cuda_build.KERNELS`` lists the ``.cu`` it compiles and
every header that source includes, directly or through another header, so
that the digest in the library's file name covers them: an edited header
must give a new library, never a stale one. The ``-Xptxas -v`` report
parser, which ``chip_smoke.py`` uses to gate register spills, is held
against a report in the compiler's format.
"""

import re
import shutil

import pytest

from polyrl_tpu_torch.ops import cuda_build

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _local_includes(path):
    """Every file of csrc/ that ``path`` includes, directly or not."""
    seen, todo = set(), [path.name]
    while todo:
        for inc in _INCLUDE.findall((path.parent / todo.pop()).read_text()):
            if inc not in seen:
                seen.add(inc)
                todo.append(inc)
    return seen


@pytest.mark.parametrize("name", sorted(cuda_build.KERNELS))
def test_every_include_is_a_listed_source(name):
    sources = cuda_build.KERNELS[name][0]
    assert sources[0].endswith(".cu")
    includes = _local_includes(cuda_build.CSRC_DIR / sources[0])
    assert includes <= set(sources[1:]), (name, includes - set(sources[1:]))
    assert set(sources[1:]) <= includes, (name, "lists a header it never includes")
    for src in sources:
        assert (cuda_build.CSRC_DIR / src).is_file(), src


_PAIRS = [(name, src) for name in sorted(cuda_build.KERNELS)
          for src in cuda_build.KERNELS[name][0]]


@pytest.mark.parametrize("name,src", _PAIRS, ids=[f"{n}-{s}" for n, s in _PAIRS])
def test_lib_path_changes_with_every_source(name, src, tmp_path, monkeypatch):
    """Editing any one source of a library renames the library; editing a
    file it does not list leaves the name alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    before = cuda_build.lib_path(name)
    (csrc / "unlisted.cuh").write_text("// not a source of any library\n")
    assert cuda_build.lib_path(name) == before
    with open(csrc / src, "a") as f:
        f.write("\n// edited\n")
    after = cuda_build.lib_path(name)
    assert after != before and after.parent == before.parent
    assert after.name.startswith(name + "-") and after.suffix == ".so"


def test_lib_path_changes_with_the_flags(monkeypatch):
    before = cuda_build.lib_path("flash_attention_fwd")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build.lib_path("flash_attention_fwd") != before


def test_fused_prologue_is_its_own_library():
    """The fused decode prologue (K1 redesigned) is one library built from
    its own .cu, with one C entry point whose argtypes match the
    parameters the source declares: 12 pointers, 8 ints, eps, the stream."""
    import ctypes

    sources, entries = cuda_build.KERNELS["paged_kv_write_fused"]
    assert sources == ("paged_kv_write_fused.cu",)
    argtypes = entries["polyrl_paged_kv_write_fused"]
    assert list(entries) == ["polyrl_paged_kv_write_fused"]
    assert argtypes == ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
                        + [ctypes.c_float, ctypes.c_void_p])
    assert cuda_build.LAUNCHES["paged_kv_write_fused"] == 0
    text = (cuda_build.CSRC_DIR / sources[0]).read_text()
    sig = re.search(r'extern "C" int polyrl_paged_kv_write_fused\((.*?)\)\s*\{',
                    text, re.S).group(1)
    params = [p_.strip() for p_ in sig.split(",")]
    kinds = [ctypes.c_void_p if "*" in p_ else
             ctypes.c_float if p_.startswith("float") else ctypes.c_int
             for p_ in params]
    assert kinds == argtypes, params
    assert cuda_build.lib_path("paged_kv_write_fused").name.startswith(
        "paged_kv_write_fused-")


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__8cc3d0be_22_flash_attention_fwd_cu_979178ff21flash_fwd_bf16_kernelILi128ELi4EEEvPK13__nv_bfloat16S3_S3_PKiPS1_Pfiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__8cc3d0be_22_flash_attention_fwd_cu_979178ff21flash_fwd_bf16_kernelILi128ELi4EEEvPK13__nv_bfloat16S3_S3_PKiPS1_Pfiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 240 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__175292a8_22_flash_attention_bwd_cu_91516b3f21flash_dkv_bf16_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PKiS3_PKfS7_PS1_S8_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__175292a8_22_flash_attention_bwd_cu_91516b3f21flash_dkv_bf16_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PKiS3_PKfS7_PS1_S8_iiiif
    24 bytes stack frame, 24 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 24 bytes cumulative stack size, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__175292a8_22_flash_attention_bwd_cu_91516b3f18flash_delta_kernelIfLi64EEEvPKT_S3_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__175292a8_22_flash_attention_bwd_cu_91516b3f18flash_delta_kernelIfLi64EEEvPKT_S3_Pfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 21 registers, 388 bytes cmem[0]
"""


def test_parse_ptxas_reads_registers_and_spills():
    rows = cuda_build.parse_ptxas(PTXAS_LOG)
    assert rows == [
        dict(kernel="flash_fwd_bf16_kernel<128, 4>", registers=240, spill_stores=0,
             spill_loads=0),
        dict(kernel="flash_dkv_bf16_kernel<128>", registers=255, spill_stores=24,
             spill_loads=32),
        dict(kernel="flash_delta_kernel<float, 64>", registers=21, spill_stores=0,
             spill_loads=0),
    ]
    assert cuda_build.parse_ptxas("") == []
    assert cuda_build.kernel_name("not_mangled") == "not_mangled"
    # the paged kernels live in namespace polyrl; the f32 split kernel is
    # no template
    assert cuda_build.kernel_name(
        "_ZN6polyrl22paged_split_f32_kernelENS_4ArgsIfEENS_4PlanE") == \
        "paged_split_f32_kernel"
    assert cuda_build.kernel_name(
        "_ZN6polyrl23paged_split_bf16_kernelILi128EEEvNS_4ArgsI13__nv_bfloat16EENS_4PlanE"
    ) == "paged_split_bf16_kernel<128>"
    assert cuda_build.kernel_name(
        "_ZN6polyrl20paged_combine_kernelI13__nv_bfloat16EEvNS_4ArgsIT_EENS_4PlanE"
    ) == "paged_combine_kernel<bf16>"
    # a kernel in an anonymous namespace whose hash ends in digits, with two
    # type arguments (the fused decode prologue's activation and pool types)
    fused = ("_ZN56_GLOBAL__N__db0c2340_23_paged_kv_write_fused_cu_ce956e05"
             "27paged_kv_write_fused_kernelI{}EEvNS_4ArgsIT_T0_EE")
    for targs, name in (("f13__nv_bfloat16", "float, bf16"),
                        ("13__nv_bfloat16S1_", "bf16, bf16"), ("ff", "float, float"),
                        ("13__nv_bfloat16f", "bf16, float")):
        assert cuda_build.kernel_name(fused.format(targs)) == \
            f"paged_kv_write_fused_kernel<{name}>"


def test_bf16_flash_kernels_use_the_tensor_core_helpers_only():
    """The bf16 K4 kernels run their products through flash_mma.cuh's
    mma.sync helpers; the f32 CUDA-core products (tile_dot, tile_acc) stay
    in the f32 kernels."""
    for src in ("flash_attention_fwd.cu", "flash_attention_bwd.cu"):
        text = (cuda_build.CSRC_DIR / src).read_text()
        bodies = re.findall(r"flash_\w+_bf16_kernel\(.*?\n}\n", text, re.S)
        assert bodies, src
        for body in bodies:
            assert "gemm_" in body
            assert "tile_dot" not in body and "tile_acc" not in body
    mma_header = (cuda_build.CSRC_DIR / "flash_mma.cuh").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in mma_header
    assert "cp.async" in mma_header and '#include "flash_f32.cuh"' not in mma_header


def _body(text, head):
    """The text of the function whose definition starts with ``head``, to
    its closing brace at column 0."""
    start = text.index(head)
    return text[start:text.index("\n}\n", start)]


def test_bf16_paged_kernels_use_the_tensor_core_helpers_only():
    """K2's and K3's bf16 instance, prefix items included, runs every item
    through attend_item_bf16, whose products are flash_mma.cuh's mma.sync
    helpers; the CUDA-core attend_tile stays in the f32 instance."""
    text = (cuda_build.CSRC_DIR / "paged_common.cuh").read_text()
    attend = _body(text, "__device__ void attend_item_bf16(")
    assert "fm::gemm_nt_reg<" in attend and "fm::gemm_pv<" in attend
    assert "fm::cp_async16(" in _body(text, "__device__ __forceinline__ void load_kv_tile(")
    split = _body(text, "    paged_split_bf16_kernel(")
    assert "for_each_item(" in split and "attend_item_bf16<D>(" in split
    assert "decode_item(" in _body(text, "__device__ __forceinline__ void for_each_item(")
    for body in (attend, split):
        assert "attend_tile" not in body and "attend_item_f32" not in body
    # decode_item hands the bf16 kernel both kinds of item: a prefix item
    # is (chunk, group, kv head, row block) over the group's prefix pages
    decode = _body(text, "__device__ __forceinline__ bool decode_item(")
    assert "it.prefix = true" in decode and "group_prefix_pages" in decode
    # both libraries launch the bf16 split kernel for dtype 1 (bfloat16)
    launch = _body(text, "inline int launch_attention(")
    assert "paged_split_bf16_kernel<128>" in launch and "case 1:" in launch
    for src in ("paged_attention.cu", "grouped_paged_attention.cu"):
        assert "polyrl::launch_attention(" in (cuda_build.CSRC_DIR / src).read_text()
