"""ELBO audit of the VI fast path on the ML-100k timeSVD++-flipped design
(synthetic, fold 0), on the CPU, for both packages.

    python -m tests.vi_elbo_audit [--n-iter 12] [--rank 10] [--float32]

1. Fits ``VariationalFMRegressor`` of the TPU package and of the port
   through "auto" and prints each one's ELBO after every sweep and its
   held-out RMSE.
2. From the port's state after two sweeps, runs every table pass of one
   sweep in both packages from the same moments and hyperparameters and
   prints the ELBO change of each pass, both evaluated with one ELBO
   (the port's refresh and group terms).  Every CAVI pass must raise the
   ELBO; the TPU package's entity+attribute passes lower it where the
   side values are not 0 or 1 (its covariance term uses Σ x s and
   Σ x² s v̄ where the update needs Σ x² s and Σ x³ s v̄).

It is not collected by pytest: a whole run takes several minutes.
"""

import argparse
import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import myfm_tpu  # noqa: E402
import myfm_tpu_torch  # noqa: E402
from myfm_tpu.design_categorical import (  # noqa: E402
    try_compile_categorical as jax_compile,
)
from myfm_tpu.ops import categorical_vi as jvi  # noqa: E402
from myfm_tpu.ops.categorical import make_y_tiles as jax_y_tiles  # noqa: E402
from myfm_tpu.ops.variational import (  # noqa: E402
    VariationalConfig as JaxConfig,
)
from myfm_tpu_torch.design_categorical import (  # noqa: E402
    try_compile_categorical,
)
from myfm_tpu_torch.ops import categorical_vi as tvi  # noqa: E402
from myfm_tpu_torch.ops.variational import (  # noqa: E402
    VariationalConfig,
    vi_update_lambda,
    vi_update_mu,
)
from myfm_tpu_torch.utils.ml_features import (  # noqa: E402
    build_feature_blocks,
    load_synthetic_movielens,
)
from myfm_tpu_torch.vi_trainer import CategoricalVITrainer  # noqa: E402


def traces(design, rank, n_iter, dtype):
    X, Xt, blocks, blocks_t, grouping, y, yt = design
    for mod, kw in ((myfm_tpu, {}), (myfm_tpu_torch, dict(device="cpu"))):
        blocks, blocks_t = ([mod.RelationBlock(b.original_to_block, b.data)
                             for b in bs] for bs in (blocks, blocks_t))
        fm = mod.VariationalFMRegressor(rank=rank, random_seed=0,
                                        dtype=dtype, **kw)
        fm.fit(X, y, X_rel=blocks, n_iter=n_iter, grouping=grouping)
        rmse = float(np.sqrt(np.mean((fm.predict(Xt, blocks_t) - yt) ** 2)))
        print(f"{mod.__name__}: engine {fm.history_.engine}, held-out RMSE "
              f"{rmse:.4f} (std {yt.std():.4f}); ELBO per sweep "
              f"{np.round(fm.history_.elbos, 1).tolist()}", flush=True)


def pass_deltas(design, rank, dtype):
    X, _, blocks, _, grouping, y, _ = design
    g = np.asarray(grouping, np.int32)
    pp = try_compile_categorical(X, blocks, g, None, dtype, "cpu",
                                 rank=3 * rank, allow_side=True)
    jp = jax_compile(X, blocks, g, None, dtype, rank=4 * rank,
                     allow_side=True)
    tr = CategoricalVITrainer(pp, y, VariationalConfig(), rank, 0.1, 0,
                              dtype)
    cfg = tr.cfg
    st = tr._initialize()
    for _ in range(2):
        st = tvi.categorical_vi_sweep(pp, st, tr.y, tr.y_tiles, cfg)
    c = st.core
    gi, gc = pp.group_index, pp.group_counts
    rate = (cfg.beta_0 + (c.e * c.e).sum() + c.e_var_sum) / 2.0
    alpha = (cfg.alpha_0 + pp.n_real) / 2.0 / rate
    lw, lwr = vi_update_lambda(c.w, c.w_var, c.mu_w, c.mu_w_var, gi, gc, cfg)
    mw, mwv = vi_update_mu(c.w, lw, gi, gc, cfg)
    lV, lVr = vi_update_lambda(c.V, c.V_var, c.mu_V, c.mu_V_var, gi, gc, cfg)
    mV, mVv = vi_update_mu(c.V, lV, gi, gc, cfg)
    hyper = dict(alpha=alpha, alpha_rate=rate, lambda_w=lw,
                 lambda_w_rate=lwr, mu_w=mw, mu_w_var=mwv, lambda_V=lV,
                 lambda_V_rate=lVr, mu_V=mV, mu_V_var=mVv)
    core = dataclasses.replace(c, **hyper)

    def elbo(m):
        eff = tvi.vi_eff_tables(pp, *m)
        score, evs = tvi.vi_refresh_rows(pp, c.w0, c.w0_var, *m, eff=eff)
        e = score - tr.y
        cc = dataclasses.replace(core, w=m[0], w_var=m[1], V=m[2],
                                 V_var=m[3])
        return float(tvi._group_elbo_terms(
            pp, cc, cfg, -alpha * (cfg.beta_0 + (e * e).sum() + evs) / 2.0))

    m = (c.w, c.w_var, c.V, c.V_var)
    jm = tuple(jnp.asarray(t.numpy()) for t in m)
    hyp = (lw, mw, lV, mV)
    jhyp = tuple(jnp.asarray(t.numpy()) for t in hyp)
    jt = jax_y_tiles(jp, jnp.asarray(tr.y.numpy()))
    base = elbo(m)
    eff = tvi.vi_eff_tables(pp, *m)
    jeff = jvi.vi_eff_tables(jp, *jm)
    for ti, si in enumerate(pp.side):
        ea = si is not None
        args = (float(c.w0), float(alpha))
        ours = (tvi._vi_ea_table_pass if ea else tvi._vi_table_pass)(
            pp, ti, *m, *args, *hyp, gi, tr.y_tiles[ti], cfg, eff)
        ref = (jvi._vi_ea_table_pass if ea else jvi._vi_table_pass)(
            jp, ti, *jm, *args, *jhyp, jp.group_index, jt[ti], JaxConfig(),
            True, jeff)
        ref = tuple(torch.as_tensor(np.asarray(a)) for a in ref)
        kind = "entity+attribute" if ea else "one-hot"
        print(f"table {ti} ({kind}, B={pp.tables[ti].n_cols}): ELBO change "
              f"port {elbo(ours) - base:+.4e}, TPU package "
              f"{elbo(ref) - base:+.4e}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-iter", type=int, default=12)
    ap.add_argument("--rank", type=int, default=10)
    ap.add_argument("--float32", action="store_true")
    a = ap.parse_args()
    dtype = np.float32 if a.float32 else np.float64
    tr, te = load_synthetic_movielens("100k", 0)
    X, Xt, b, bt, grouping = build_feature_blocks(tr, te,
                                                  "timesvdpp_flipped")
    design = (X, Xt, b, bt, grouping, tr["rating"], te["rating"])
    pass_deltas(design, a.rank, dtype)
    traces(design, a.rank, a.n_iter, dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
