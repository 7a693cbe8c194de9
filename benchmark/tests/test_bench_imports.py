"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program: each checked in a fresh
interpreter, top-level module names compared whole."""

import json
import subprocess
import sys

import pytest
from fmbench import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "myfm_tpu")


def loaded_after(code: str):
    prog = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(registry.BENCH_DIR)!r}, "
        f"{str(registry.ROOT)!r}]\n" + code +
        "\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    )
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    top = loaded_after(
        "from fmbench import cell, registry, trace, roofline, data\n"
        "import myfm_tpu_torch, myfm_tpu_torch.utils.callbacks\n"
        "spec = registry.load_spec()\n"
        "for w in spec['workloads']:\n"
        "    c = registry.cell(w['name'], spec)\n"
        "    registry.reference(c['config'])\n")
    assert "myfm_tpu_torch" in top
    assert not top & set(FORBIDDEN)


@pytest.mark.parametrize("reference", ["fm_gibbs", "fm_gibbs_side"])
def test_reference_loads_nothing_of_the_program(reference):
    """Loading a reference module and building its design of both
    splits (what set-up does) load nothing of the program."""
    config = ("registry.cell('ml10m_r32.chain', registry.load_spec())"
              "['config']" if reference == "fm_gibbs" else
              f"json.load(open({str(registry.BENCH_DIR / 'tests')!r} + "
              "'/ml100k_tsvdpp_r8.json'))")
    top = loaded_after(
        "import json\n"
        "from fmbench import data, registry\n"
        f"config = {config}\n"
        "config['dataset'].update(rows=3000, users=40, items=30, days=7,"
        " min_user_ratings=0)\n"
        "ref = registry.reference(config)\n"
        "train, test = data.make_ratings(config['dataset'], 1, 'cpu')\n"
        "ref.design(config, train, test)\n")
    assert not top & {"myfm_tpu_torch", *FORBIDDEN}


def test_forbidden_names_compare_whole():
    from fmbench import cell

    sys.modules.setdefault("myfm_tpu_torch_lookalike", sys)
    try:
        assert "myfm_tpu_torch_lookalike" not in cell.forbidden_modules()
    finally:
        del sys.modules["myfm_tpu_torch_lookalike"]
