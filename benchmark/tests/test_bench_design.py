"""A configuration's design comes from its reference module: the one-hot
design moved into ``configs/fm_gibbs.py`` is byte for byte the harness's
former one, the ratings without a degree model are the former ones bit
for bit, and a side-feature design (``configs/fm_gibbs_side.py`` with
the test configuration ``ml100k_tsvdpp_r8.json``) runs through
``run_cell`` with no file of ``fmbench/`` naming it: correct as the
program runs it, and not correct under each fault planted in the
program's side-feature path."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import TINY
from fmbench import cell, data, registry

HERE = Path(__file__).resolve().parent
SPEC = registry.load_spec()
SIDE = "ml100k_tsvdpp_r8"
# the side configuration at a size the CPU runs in seconds
SIDE_TINY = dict(dataset=dict(rows=20_000, users=300, items=120, days=50,
                              min_user_ratings=20))


def frozen_one_hot_design(split, config):
    """The harness's one-hot design before it moved to the reference
    module (fmbench/cell.py), as it was."""
    import scipy.sparse as sps

    from myfm_tpu_torch import RelationBlock

    n = len(split)
    shape = config["dataset"]
    main = [t for t in config["tables"] if t["layout"] == "main"]
    widths = [shape[t["entities"]] for t in main]
    cols = np.stack([getattr(split, t["column"]) + off for t, off in
                     zip(main, np.cumsum([0] + widths[:-1]))], axis=1)
    X = sps.csr_matrix(
        (np.ones(cols.size), cols.reshape(-1),
         np.arange(0, cols.size + 1, len(main))),
        shape=(n, sum(widths)))
    blocks = [RelationBlock(getattr(split, t["column"]),
                            sps.identity(shape[t["entities"]], format="csr"))
              for t in config["tables"] if t["layout"] == "block"]
    grouping = [g for g, t in enumerate(config["tables"])
                for _ in range(shape[t["entities"]])]
    return X, blocks, grouping


def frozen_make_ratings(shape, seed, device):
    """fmbench/data.make_ratings before its degree model, as it was."""
    n, n_users, n_items = shape["rows"], shape["users"], shape["items"]
    n_days = shape["days"]
    n_test = int(n * shape["test_share"])
    structure = data._seed_generator(data.STRUCTURE_SEED, device)
    weights = dict(
        user=(data._pareto(1.5, n_users, structure, device) + 0.5),
        item=(data._pareto(1.2, n_items, structure, device) + 0.1),
        day=torch.ones(n_days, dtype=torch.float64, device=device))
    gen = data._seed_generator(seed, device)

    def ids(weight):
        owner = torch.randperm(len(weight), generator=gen, device=device)
        return torch.cat([
            torch.repeat_interleave(owner, data.degree_counts(rows, weight))[
                torch.randperm(rows, generator=gen, device=device)]
            for rows in (n_test, n - n_test)])

    user, item, day = (ids(weights[k]) for k in ("user", "item", "day"))

    def normal(*size):
        return torch.randn(*size, generator=gen, dtype=torch.float64,
                           device=device)

    uf = normal(n_users, data.LATENT_RANK) / data.LATENT_RANK ** 0.5
    vf = normal(n_items, data.LATENT_RANK) / data.LATENT_RANK ** 0.5
    score = ((uf[user] * vf[item]).sum(dim=1)
             + 0.4 * normal(n_users)[user] + 0.4 * normal(n_items)[item]
             + 0.6 * normal(n))
    ranked = score.sort().values
    cuts = ranked[[int(q * (n - 1)) for q in data.STAR_QUANTILES]]
    stars = 1.0 + (score[:, None] >= cuts[None, :]).sum(dim=1).double()
    host = [t.cpu().numpy() for t in (day, user, item, stars)]
    return (data.Ratings(*(a[n_test:] for a in host)),
            data.Ratings(*(a[:n_test] for a in host)))


def tiny_config(name):
    config = registry.cell(name, SPEC)["config"]
    return dict(config, rank=TINY["rank"],
                dataset=dict(config["dataset"], **TINY["dataset"]))


def csr_bytes(m):
    return [m.shape, m.indptr.tobytes(), m.indices.tobytes(),
            m.data.tobytes(), str(m.data.dtype)]


@pytest.mark.parametrize("workload", ["ml10m_r128.chain", "ml10m_r32.chain"])
def test_moved_one_hot_design_is_byte_identical(workload):
    from myfm_tpu_torch.design_cache import design_fingerprint

    config = tiny_config(workload)
    ref = registry.reference(config)
    train, test = data.make_ratings(config["dataset"], 2 ** 31 + 3, "cpu")
    design = ref.design(config, train, test)
    for split, name in ((train, "train"), (test, "test")):
        X0, blocks0, grouping0 = frozen_one_hot_design(split, config)
        X1, blocks1, grouping1 = cell._program_design(
            design["program"][name])
        assert csr_bytes(X0) == csr_bytes(X1)
        assert grouping0 == grouping1
        assert len(blocks0) == len(blocks1) == 2
        for b0, b1 in zip(blocks0, blocks1):
            assert b0.original_to_block.tobytes() == \
                b1.original_to_block.tobytes()
            assert csr_bytes(b0.data) == csr_bytes(b1.data)
        assert design_fingerprint(X0, blocks0, grouping0) == \
            design_fingerprint(X1, blocks1, grouping1)


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 99])
def test_ratings_without_a_degree_model_are_bit_equal(seed):
    shape = dict(rows=6000, users=70, items=40, days=9, test_share=0.1)
    now, before = data.make_ratings(shape, seed, "cpu"), \
        frozen_make_ratings(shape, seed, "cpu")
    for a, b in zip(now, before):
        for k in ("day", "user", "item", "y"):
            assert getattr(a, k).tobytes() == getattr(b, k).tobytes()


def test_degree_model_keys_shape_the_degrees():
    shape = dict(rows=6000, users=70, items=40, days=9, test_share=0.1,
                 user_pareto=[4.0, 0.8], item_pareto=[3.0, 0.2],
                 min_user_ratings=30)
    train, test = data.make_ratings(shape, 5, "cpu")
    assert len(train) == 5400 and len(test) == 600
    assert np.bincount(train.user, minlength=70).min() >= 30
    # the same degrees on another seed, by other ids
    other, _ = data.make_ratings(shape, 6, "cpu")
    for k, n in (("user", 70), ("item", 40)):
        assert sorted(np.bincount(getattr(train, k), minlength=n)) == \
            sorted(np.bincount(getattr(other, k), minlength=n))
    with pytest.raises(ValueError):
        data.make_ratings(dict(shape, min_user_ratings=100), 5, "cpu")


def side_bench(tmp_path):
    """A benchmark directory holding the side configuration beside the
    benchmark's own mixes and readers, and its spec: the harness finds
    the configuration by name as it finds the cells'."""
    bench = registry.BENCH_DIR
    for sub in ("traffic", "metrics"):
        (tmp_path / sub).symlink_to(bench / sub)
    (tmp_path / "configs").mkdir()
    (tmp_path / "limits").mkdir()
    for f in ("fm_gibbs.py", "fm_gibbs_side.py"):
        (tmp_path / "configs" / f).symlink_to(bench / "configs" / f)
    (tmp_path / "configs" / f"{SIDE}.json").symlink_to(HERE / f"{SIDE}.json")
    workloads = []
    for traffic in ("chain", "libfm"):
        name = f"{SIDE}.{traffic}"
        (tmp_path / "limits" / f"{name}.json").symlink_to(
            HERE / f"{name}.json")
        workloads.append(dict(name=name, config=SIDE, traffic=traffic,
                              chips=1))
    return tmp_path, dict(SPEC, workloads=workloads)


def run_side(tmp_path, traffic="chain", seed=2 ** 31 + 21):
    """A run of the side configuration on the CPU."""
    bench, spec = side_bench(tmp_path)
    return cell.run_cell(f"{SIDE}.{traffic}", seed, 0.5, False,
                         time.perf_counter(), device="cpu", spec=spec,
                         bench_dir=bench, overrides=SIDE_TINY)


def test_side_configuration_is_only_files_of_its_own():
    config = json.loads((HERE / f"{SIDE}.json").read_text())
    assert config["reference"] == "fm_gibbs_side"
    assert config["features"] == "timesvdpp_flipped"
    for path in (registry.BENCH_DIR / "fmbench").glob("*.py"):
        text = path.read_text()
        assert SIDE not in text and "fm_gibbs_side" not in text, path


@pytest.mark.parametrize("traffic", ["chain", "libfm"])
def test_side_design_runs_correct(tmp_path, traffic):
    result, observed = run_side(tmp_path, traffic)
    assert result["correct"], result["checks"]
    shape = observed["design"]
    # five groups: date, user, movie one-hot; two blocks' side columns
    assert len(shape["entities"]) == 3 and len(shape["block_rows"]) == 2
    assert min(shape["colors"]) > 1 and min(shape["side_nonzeros"]) > 0
    assert observed["sweep_flops"] > 0
    if traffic == "libfm":
        assert {"score_gap", "rmse_gap"} <= set(result["checks"])


def test_side_draw_moved_by_one_conditional_sd(tmp_path, monkeypatch):
    """In each sweep's first side pass (the users' implicit movies) the
    first colour moves the w of its feature with the most rows by that
    draw's conditional sd."""
    from myfm_tpu_torch.ops import categorical, joint

    scan, draw = categorical.ea_color_scan, joint._draw_u
    passes, first = [0], [False]

    def counted_scan(*a, **k):
        first[0] = passes[0] % 2 == 0
        passes[0] += 1
        return scan(*a, **k)

    def moved(S, t, u_old, lam, mu, alpha, xi):
        u = draw(S, t, u_old, lam, mu, alpha, xi)
        if first[0]:
            first[0] = False
            p = int(S[:, 0, 0].argmax())
            A = alpha * S[p] + torch.diag(lam[p])
            u = u.clone()
            u[p, 0] += torch.linalg.inv(A)[0, 0].sqrt()
        return u

    monkeypatch.setattr(categorical, "ea_color_scan", counted_scan)
    monkeypatch.setattr(joint, "_draw_u", moved)
    result, _ = run_side(tmp_path)
    assert not result["correct"]
    gap = result["checks"]["weight_gap_sd"]
    assert gap["value"] > 0.9 and gap["at"].startswith("w"), gap


def test_implicit_values_set_to_one(tmp_path, monkeypatch):
    from myfm_tpu_torch import design_categorical

    inner = design_categorical.compile_side_info

    def ones(Xs, *a, **k):
        import scipy.sparse as sps

        Xs = sps.csr_matrix(Xs, copy=True)
        Xs.data[:] = 1.0
        return inner(Xs, *a, **k)

    monkeypatch.setattr(design_categorical, "compile_side_info", ones)
    result, _ = run_side(tmp_path)
    assert not result["correct"]
    assert result["checks"]["weight_gap_sd"]["value"] > 1


def test_two_colours_swapped(tmp_path, monkeypatch):
    from myfm_tpu_torch import design

    inner = design.greedy_color

    def swapped(csc, *a, **k):
        colors = list(inner(csc, *a, **k))
        colors[0], colors[1] = colors[1], colors[0]
        return colors

    monkeypatch.setattr(design, "greedy_color", swapped)
    result, _ = run_side(tmp_path)
    assert not result["correct"]
    assert result["checks"]["weight_gap_sd"]["value"] > \
        result["checks"]["weight_gap_sd"]["limit"]
