"""The paper's experiment harness (counterpart of ``benchmarks/common.py``).

One entry point, ``run_experiment``, reproduces at configurable scale:

- Table 1  — fixed-device training, CIFAR-like, {IID, Dir(a), shards} x
  ``METHODS_FIXED``;
- Fig 6/7  — mobile-device training, CIFAR-like Shards, vs Gossip/OppCL/Local;
- Fig 8/9  — mobile-device training, IMU HAR (the LSTM-CNN);

under the random-walk mobility model (P_cross), synthetic 4Q traces or a
registered scenario. The pieces are public so that a caller can assemble
its own run: the data layouts (``image_data_fixed``, ``image_data_mobile``,
``har_data_mobile``; numpy draws bitwise the reference's), the models'
train/eval functions (``model_fns``, ``cnn_model_fns``,
``lstm_cnn_model_fns``), minibatch draws (``sample_batches``,
``batch_sampler``), per-device pretraining (``make_pretrain``) and the
schedule (``mobility_tensors``). ``run_with_models`` is the body of
``run_experiment`` with the model functions handed in, and also returns
what the run holds at its end.

``run_sweep_experiment`` runs the engine's methods over several seeds at
once (``scenarios.sweep.run_sweep``, the seeds as lanes of one replay;
``run_sweep_distributed`` with ``distributed``): the paper's seed-averaged
curves. ``run_sweep_with_models`` is its body.

Seeds: torch cannot reproduce ``jax.random``, so the harness draws from
integer seeds (``core/seeds.py``) in the reference's places. Model ``c``
is the ``c``-th draw of a ``torch.Generator`` seeded with ``cfg.seed``.
Pretraining step ``i`` draws batches with ``fold_in(k_i, 0)`` and trains
with ``fold_in(k_i, 1)``, where ``k_i = fold_in(cfg.seed + 7, i)``.
Federated round ``r`` does the same from ``fold_in(cfg.seed + 100, r)``,
and the engine runs from the key ``cfg.seed + 100`` (its step ``t``
folds in ``t``). The post-local epoch ``e`` starts from
``fold_in(fold_in(cfg.seed + 100, -1), e)``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.baselines.cfl import CFLState, cfl_client_models, cfl_round
from repro_torch.baselines.fedas import fedas_round
from repro_torch.baselines.fedavg import broadcast, fedavg_round
from repro_torch.configs.mule_cnn import CNNConfig
from repro_torch.configs.mule_lstm_cnn import LSTMCNNConfig
from repro_torch import interop
from repro_torch.core.aggregation import weighted_average
from repro_torch.core.distributed import (DistributedConfig,
                                          to_distributed_state)
from repro_torch.core.freshness import FreshnessConfig
from repro_torch.core.population import (METHODS_MOBILE, PopulationConfig,
                                         _stack, init_population)
from repro_torch.core.seeds import fold_in, split
from repro_torch.data import (dirichlet_partition, iid_partition,
                              make_image_dataset, make_imu_dataset,
                              shards_partition, train_test_split)
from repro_torch.device import resolve_device
from repro_torch.launch.multiprocess import gather_global
from repro_torch.mobility import compact_colocation, synth_foursquare_trace
from repro_torch.models.cnn import (accuracy, cnn_forward, init_cnn,
                                    init_lstm_cnn, lstm_cnn_forward,
                                    xent_loss)
from repro_torch.scenarios import (get_scenario, run_population,
                                   run_population_distributed,
                                   run_population_streamed, run_sweep,
                                   run_sweep_distributed,
                                   scenario_generator, stack_colocations,
                                   stack_trees, trace_colocation,
                                   walk_colocation)

METHODS_FIXED = ("mlmule", "fedavg", "cfl", "fedas", "local")
FEDERATED = ("fedavg", "cfl", "fedas")

@dataclasses.dataclass
class ExperimentConfig:
    task: str = "image"            # image | har
    mode: str = "fixed"            # fixed | mobile
    method: str = "mlmule"
    dist: str = "dir0.01"          # iid | dir<alpha> | shards
    pattern: str = "0.1"           # P_cross value as str, or "4q"
    steps: int = 300
    eval_every: int = 50
    n_mules: int = 12
    n_fixed: int = 8
    batch: int = 16
    lr: float = 0.05
    seed: int = 0
    image_size: int = 16
    n_super: int = 20
    n_sub: int = 5
    n_per_sub: int = 16
    noise: float = 3.0
    train_per_device: int = 32   # local-overfitting regime (paper operating point)
    post_local_epochs: int = 1     # Table 1 "Post-Local" fine-tune
    pretrain_steps: int = 120      # per-device local pretraining to the
                                   # paper's 'accuracy stops improving' point
    freshness_off: bool = False    # ablation: disable the staleness filter
    gamma: float = 0.3
    scenario: str = ""             # registry scenario name; overrides
                                   # mode/dist/task/pattern when set
    distributed: bool = False      # the mule-sharded engine over the ranks
    stream: bool = False           # the schedule generated chunk by chunk
    stream_chunk: int = 0          # steps per streamed chunk (0: default)
    rebucket_every: int = 0        # distributed runs: re-bucketing cadence
    rebucket_threshold: float = 0.25   # drift fraction that triggers a swap


# ---------------------------------------------------------------------------
# data assembly
# ---------------------------------------------------------------------------


def _pad_to(idx_list: List[np.ndarray], rng) -> np.ndarray:
    n = max(len(i) for i in idx_list)
    out = []
    for i in idx_list:
        if len(i) < n:
            i = np.concatenate([i, rng.choice(i, n - len(i))])
        out.append(i)
    return np.stack(out)


def _on(dev: torch.device, *arrays) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(a, device=dev) for a in arrays)


def image_data_fixed(cfg: ExperimentConfig, device="cuda"
                     ) -> Tuple[torch.Tensor, ...]:
    """Per-fixed-device train/test arrays for the Table 1 setting.

    Returns ``(Xtr [F, N, H, W, 3], Ytr [F, N], Xte [F, Nt, H, W, 3],
    Yte [F, Nt])`` on ``device``, bitwise the reference's for ``cfg``.
    """
    dev = resolve_device(device)
    x, sup, sub = make_image_dataset(cfg.seed, cfg.n_per_sub, cfg.n_super,
                                     cfg.n_sub, cfg.image_size, cfg.noise)
    rng = np.random.default_rng(cfg.seed)
    if cfg.dist == "iid":
        parts = iid_partition(sup, cfg.n_fixed, cfg.seed)
    elif cfg.dist.startswith("dir"):
        parts = dirichlet_partition(sup, cfg.n_fixed, float(cfg.dist[3:]),
                                    cfg.seed, min_per_part=24)
    elif cfg.dist == "shards":
        n_areas = max(-(-cfg.n_fixed // 4), 2)     # ceil, 4 spaces per area
        sh = shards_partition(sup, sub, n_areas=n_areas, seed=cfg.seed)
        parts = [np.concatenate([sh["space_idx"][(a, s)],
                                 sh["general_idx"][(a, s)]])
                 for a in range(n_areas) for s in range(4)]
    else:
        raise ValueError(cfg.dist)
    tr, te = zip(*[train_test_split(p, 0.2, cfg.seed) for p in parts])
    tr = [t[: cfg.train_per_device] for t in tr]
    tr, te = _pad_to(list(tr), rng), _pad_to(list(te), rng)
    return _on(dev, x[tr], sup[tr], x[te], sup[te])


def image_data_mobile(seed: int, n_mules: int, n_fixed: int,
                      mule_space: np.ndarray, mule_area: np.ndarray, *,
                      n_per_sub: int = 16, n_super: int = 20, n_sub: int = 5,
                      image_size: int = 32, noise: float = 3.0,
                      train_per_device: int = 32, device="cuda"
                      ) -> Tuple[torch.Tensor, ...]:
    """Shards data on mules per Sec 4.3.1: space's sub-class + 5th sub-class.

    Returns ``(Xtr [M, N, H, W, 3], Ytr [M, N], Xte [S, Nt, H, W, 3],
    Yte [S, Nt])`` on ``device``; ``Xte[s]`` is space ``s``'s test set.
    """
    dev = resolve_device(device)
    x, sup, sub = make_image_dataset(seed, n_per_sub, n_super, n_sub,
                                     image_size, noise)
    # ceil so every place id's area (place // 4) has a partition, min 2
    n_areas = max(-(-n_fixed // 4), 2)
    sh = shards_partition(sup, sub, n_areas=n_areas, seed=seed)
    rng = np.random.default_rng(seed + 1)
    tr_list = []
    for m in range(n_mules):
        key = (int(mule_area[m]), int(mule_space[m]))
        local = sh["space_idx"][key]
        general = sh["general_idx"][key]
        cap = max(train_per_device // 2, 8)
        take = rng.choice(local, min(len(local), cap), replace=False)
        takeg = rng.choice(general, min(len(general), cap), replace=False)
        tr_list.append(np.concatenate([take, takeg]))
    tr = _pad_to(tr_list, rng)
    te_idx = _pad_to([sh["space_idx"][(a, s)] for a in range(n_areas)
                      for s in range(4)], rng)
    return _on(dev, x[tr], sup[tr], x[te_idx], sup[te_idx])


def har_data_mobile(cfg: ExperimentConfig, mule_space: np.ndarray,
                    mule_area: np.ndarray, device="cuda"
                    ) -> Tuple[torch.Tensor, ...]:
    """IMU data per location; spaces map to EgoExo4D-like locations.

    Returns ``(Xtr [M, N, T, C], Ytr [M, N], Xte [8, Nt, T, C], Yte [8, Nt])``
    on ``device``, bitwise the reference's for ``cfg``.
    """
    dev = resolve_device(device)
    x, y, loc = make_imu_dataset(cfg.seed, n_per_cell=cfg.n_per_sub)
    rng = np.random.default_rng(cfg.seed + 2)
    space_loc = rng.permutation(8)          # each space -> a location
    tr_list = []
    for m in range(cfg.n_mules):
        sl = space_loc[int(mule_area[m]) * 4 + int(mule_space[m])]
        idx = np.where(loc == sl)[0]
        tr_list.append(rng.choice(idx, min(len(idx), 120), replace=False))
    tr = _pad_to(tr_list, rng)
    te_idx = _pad_to([np.where(loc == space_loc[f])[0][:60] for f in range(8)],
                     rng)
    return _on(dev, x[tr], y[tr], x[te_idx], y[te_idx])


# ---------------------------------------------------------------------------
# model / train / eval
# ---------------------------------------------------------------------------


def _sgd_fns(init: Callable, forward: Callable, lr: float
             ) -> Tuple[Callable, ...]:
    def train_fn(params, batch, key):
        xb, yb = batch
        g = torch.func.grad(lambda p: xent_loss(forward(p, xb), yb))(params)
        return {k: p - lr * g[k] for k, p in params.items()}

    def eval_fn(params, xd, yd):
        return accuracy(forward(params, xd), yd)

    return init, train_fn, eval_fn


def cnn_model_fns(cfg: CNNConfig, lr: float) -> Tuple[Callable, ...]:
    """``(init_fn(generator), train_fn(params, batch, key),
    eval_fn(params, x, y))`` — one SGD step on the cross-entropy."""
    return _sgd_fns(lambda generator: init_cnn(generator, cfg), cnn_forward,
                    lr)


def lstm_cnn_model_fns(cfg: LSTMCNNConfig, lr: float
                       ) -> Tuple[Callable, ...]:
    """The LSTM-CNN's ``(init_fn, train_fn, eval_fn)``, as ``cnn_model_fns``."""
    return _sgd_fns(lambda generator: init_lstm_cnn(generator, cfg),
                    lstm_cnn_forward, lr)


def model_fns(cfg: ExperimentConfig) -> Tuple[Callable, ...]:
    """The harness's reduced models: the CNN at conv 8/16, hidden 64, or the
    LSTM-CNN at conv 16/32, LSTM 32."""
    if cfg.task == "image":
        return cnn_model_fns(CNNConfig(image_size=cfg.image_size,
                                       conv_features=(8, 16), hidden=64,
                                       n_classes=cfg.n_super), cfg.lr)
    return lstm_cnn_model_fns(LSTMCNNConfig(conv_features=(16, 32),
                                            lstm_hidden=32, n_classes=4),
                              cfg.lr)


def sample_batches(seed: int, X: torch.Tensor, Y: torch.Tensor, batch: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """X: [P, N, ...] -> uniform minibatches [P, B, ...] of each row, drawn
    on ``X``'s device from a generator seeded with ``seed``."""
    g = torch.Generator(device=X.device)
    g.manual_seed(seed)
    idx = torch.randint(0, X.shape[1], (X.shape[0], batch), generator=g,
                        device=X.device)
    rows = torch.arange(X.shape[0], device=X.device)[:, None]
    return X[rows, idx], Y[rows, idx]


def batch_sampler(X: torch.Tensor, Y: torch.Tensor, batch: int) -> Callable:
    """Mobile-mode ``(seed, t) -> {"fixed": None, "mule": (xb [M, B, ...],
    yb [M, B])}`` for the engine's callable ``batches``."""
    def batch_fn(seed, t):
        return {"fixed": None, "mule": sample_batches(seed, X, Y, batch)}

    return batch_fn


def make_pretrain(train_fn: Callable, cfg: ExperimentConfig, n_clients: int,
                  sampler: Callable) -> Callable:
    """Per-device local pretraining: ``(models, seed) -> models``.

    A loop over ``cfg.pretrain_steps`` vmapped ``train_fn`` calls. Step
    ``i`` takes its batches from ``sampler(fold_in(k_i, 0), i)`` and trains
    with the seeds ``split(fold_in(k_i, 1), n_clients)``, where
    ``k_i = fold_in(seed, i)``.
    """
    def pretrain(models, seed):
        dev = next(iter(models.values())).device
        for i in range(cfg.pretrain_steps):
            k = fold_in(seed, i)
            keys = split(fold_in(k, 1), n_clients, dev)
            models = torch.func.vmap(train_fn)(models, sampler(fold_in(k, 0),
                                                               i), keys)
        return models

    return pretrain


# ---------------------------------------------------------------------------
# mobility stream
# ---------------------------------------------------------------------------


def mobility_tensors(cfg: ExperimentConfig):
    """Precomputed co-location schedule (see ``scenarios.registry``).

    Returns (colocation dict with fixed_id/exchange [T, M], pos [T, M, 2],
    area [M]; plus init_space/init_area), mule_space [M], mule_area [M].
    """
    if cfg.scenario:
        co = get_scenario(cfg.scenario).colocation(cfg.seed, cfg.n_mules,
                                                   cfg.steps)
    elif cfg.pattern == "4q":
        visits = synth_foursquare_trace(cfg.seed, n_users=cfg.n_mules,
                                        n_places=8, n_steps=cfg.steps)
        co = trace_colocation(visits, cfg.n_mules, cfg.steps)
    else:
        co = walk_colocation(cfg.seed, cfg.n_mules, cfg.steps,
                             p_cross=float(cfg.pattern))
    return co, co["init_space"], co["init_area"]


# ---------------------------------------------------------------------------
# the experiment entry point
# ---------------------------------------------------------------------------


def with_scenario(cfg: ExperimentConfig) -> ExperimentConfig:
    """``cfg`` with a named scenario's mode, dist, task and n_fixed."""
    if not cfg.scenario:
        return cfg
    spec = get_scenario(cfg.scenario)
    return dataclasses.replace(cfg, mode=spec.mode, dist=spec.dist,
                               task=spec.task, n_fixed=spec.n_fixed)


def _clock(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def run_experiment(cfg: ExperimentConfig, device="cuda") -> Dict:
    """Run one method of one experiment; returns ``{"config", "trace",
    "pre_local_acc", "post_local_acc", "wall_s"}``, the reference's keys.

    ``trace`` holds ``(step, mean accuracy)`` pairs: federated round ``r``
    covers steps ``[10 r, 10 (r + 1))`` and is logged at ``10 (r + 1) - 1``,
    every ``max(eval_every // 10, 1)`` rounds; the engine's methods log
    after step ``(i + 1) eval_every - 1``.
    """
    return run_with_models(cfg, model_fns(with_scenario(cfg)), device)[0]


def _mule_mesh(n_mules: int):
    """The (1, k) mesh of ``distributed`` runs: every rank of the world on
    the data axis (a rank outside the mesh would never join its
    collectives), so ``n_mules`` must divide over the world. Prints the
    mesh; one process gives k = 1, the distributed code path with nothing
    cut."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mule_mesh
    k = dist.get_world_size() if dist.is_initialized() else 1
    if n_mules % k:
        raise ValueError(f"distributed run: n_mules={n_mules} must divide "
                         f"over all {k} ranks")
    print(f"distributed mesh: 1 pod x {k} mule shards (n_mules={n_mules})"
          + (": k=1 shards nothing" if k == 1 else ""))
    return make_mule_mesh(1, k)


def _experiment_data(cfg: ExperimentConfig, mule_space, mule_area,
                     dev: torch.device) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """``((Xtr, Ytr, Xte, Yte), n_clients)`` of ``cfg``'s task and mode."""
    if cfg.mode == "fixed":
        return image_data_fixed(cfg, dev), cfg.n_fixed
    if cfg.task == "image":
        return image_data_mobile(
            cfg.seed, cfg.n_mules, cfg.n_fixed, mule_space, mule_area,
            n_per_sub=cfg.n_per_sub, n_super=cfg.n_super, n_sub=cfg.n_sub,
            image_size=cfg.image_size, noise=cfg.noise,
            train_per_device=cfg.train_per_device, device=dev), cfg.n_mules
    return har_data_mobile(cfg, mule_space, mule_area, dev), cfg.n_mules


def _population_config(cfg: ExperimentConfig) -> PopulationConfig:
    fresh = (FreshnessConfig(init_threshold=1e9, warmup=10**9)
             if cfg.freshness_off else FreshnessConfig())
    return PopulationConfig(mode=cfg.mode, n_fixed=cfg.n_fixed,
                            n_mules=cfg.n_mules, gamma=cfg.gamma,
                            freshness=fresh)


def _engine_population(cfg: ExperimentConfig, pcfg: PopulationConfig,
                       init: Callable, pre_models, mule_space, mule_area,
                       dev: torch.device) -> Dict[str, Any]:
    """The engine's initial population: the pretrained models on the
    training side; in fixed mode each mule starts with a snapshot from its
    initial space (its user's 'home' space)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    pop = init_population(pcfg, init, gen, device=dev)
    if cfg.mode == "fixed":
        pop["fixed_models"] = pre_models
        home = torch.as_tensor(np.asarray(mule_area) * 4
                               + np.asarray(mule_space), device=dev)
        pop["mule_models"] = {k: v[home] for k, v in pre_models.items()}
    else:
        pop["mule_models"] = pre_models
    return pop


def _side(cfg: ExperimentConfig, sampled) -> Dict[str, Any]:
    """The engine's batches dict with ``sampled`` on the training side."""
    if cfg.mode == "fixed":
        return {"fixed": sampled, "mule": None}
    return {"fixed": None, "mule": sampled}


def run_with_models(cfg: ExperimentConfig, fns: Tuple[Callable, ...],
                    device="cuda") -> Tuple[Dict, Dict[str, Any]]:
    """``run_experiment``'s body with ``fns = (init_fn, train_fn, eval_fn)``
    handed in. Returns ``(result, state)``; ``state`` holds
    ``pre_models`` and ``final_models`` (stacked), ``pretrain_s`` and
    ``run_s`` (seconds, the device synchronised), and

    - for ``fedavg`` and ``fedas``: ``global0`` and ``global``, the server
      model before the first round and after the last; for ``cfl``: the
      ``CFLState`` as ``cfl``;
    - for the engine's methods: ``engine``, the name of the engine that
      ran (``run_population``, or with ``cfg.stream`` /
      ``cfg.distributed`` ``run_population_streamed`` /
      ``run_population_distributed``), ``run``, the keyword arguments
      handed to it (its initial population included), and its
      ``population`` and ``aux`` at the end.

    ``cfg.stream`` replays the schedule chunk by chunk
    (``run_population_streamed`` over the scenario's generator, or the
    compacted schedule), bitwise the materialized run. ``cfg.distributed``
    cuts the mules over the ranks of the world
    (``run_population_distributed``, or the streamed engine with a mesh
    when ``cfg.stream`` is set too; ``rebucket_every`` re-buckets between
    chunks). In mobile mode an eval inside the run would read only a
    rank's mules, so it runs once, on the gathered final state; the
    population and ``last_fid`` come back gathered on every rank.
    """
    t_start = time.time()
    dev = resolve_device(device)
    cfg = with_scenario(cfg)
    federated = cfg.method in FEDERATED
    if federated and cfg.steps < 10:
        raise ValueError(f"{cfg.method} runs steps // 10 rounds: steps="
                         f"{cfg.steps} runs none")
    init, train_fn, eval_fn = fns
    colocation, mule_space, mule_area = mobility_tensors(cfg)
    (Xtr, Ytr, Xte, Yte), n_clients = _experiment_data(cfg, mule_space,
                                                       mule_area, dev)

    key = cfg.seed + 100
    eval_v = torch.func.vmap(eval_fn)

    def sampler(seed, i=None):
        return sample_batches(seed, Xtr, Ytr, cfg.batch)

    # -- per-device local pretraining (paper Sec 4.2.1 / 4.3.1) --------------
    t0 = _clock(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    pre_models = make_pretrain(train_fn, cfg, n_clients, sampler)(
        _stack([init(gen) for _ in range(n_clients)]), cfg.seed + 7)
    t1 = _clock(dev)
    state: Dict[str, Any] = {"pre_models": pre_models, "pretrain_s": t1 - t0}

    def eval_fixed_models(models):
        """Evaluate stacked fixed-device models on their space test sets."""
        return eval_v(models, Xte, Yte).cpu().numpy()

    def eval_mobile_models(models, cur_fid):
        """Each mule evaluated on the test set of its current/last space."""
        fid = torch.as_tensor(cur_fid, device=dev).clamp(min=0)
        return eval_v(models, Xte[fid], Yte[fid]).cpu().numpy()

    traces = []
    sizes = torch.full((n_clients,), float(Xtr.shape[1]), device=dev)

    # ---------------- federated baselines (round-based, no mobility) --------
    if federated:
        n_rounds = cfg.steps // 10
        model = weighted_average(pre_models, sizes)
        state["global0"] = model
        if cfg.method == "cfl":
            st = CFLState(clusters=[np.arange(n_clients)], models=[model],
                          eps1=0.5, eps2=0.05)
        if cfg.method == "fedas":
            clients = pre_models
        for r in range(n_rounds):
            kr = fold_in(key, r)
            batches, kt = sampler(fold_in(kr, 0)), fold_in(kr, 1)
            if cfg.method == "fedavg":
                model = fedavg_round(model, batches, sizes, train_fn, kt,
                                     local_steps=2)
                stacked = broadcast(model, n_clients)
            elif cfg.method == "cfl":
                st = cfl_round(st, batches, sizes, train_fn, kt,
                               local_steps=2)
                stacked = cfl_client_models(st, n_clients)
            else:
                model, clients = fedas_round(model, clients, batches, sizes,
                                             train_fn, kt)
                stacked = clients
            if (r + 1) % max(cfg.eval_every // 10, 1) == 0:
                acc = (eval_fixed_models(stacked) if cfg.mode == "fixed" else
                       eval_mobile_models(stacked,
                                          np.arange(n_clients) % cfg.n_fixed))
                # log the post-step index (round r covers steps
                # [r*10, (r+1)*10)), matching the mobility methods' x-axis
                traces.append(((r + 1) * 10 - 1, float(acc.mean())))
        final_models = stacked
        if cfg.method == "cfl":
            state["cfl"] = st
        else:
            state["global"] = model

    # ---------------- mobility-coupled methods (the scenario engine) --------
    else:
        pcfg = _population_config(cfg)
        pop = _engine_population(cfg, pcfg, init, pre_models, mule_space,
                                 mule_area, dev)

        def batch_fn(seed, t):
            return _side(cfg, sampler(seed))

        if cfg.mode == "fixed":
            def eval_hook(st, last):
                return eval_v(st["fixed_models"], Xte, Yte)
        else:
            def eval_hook(st, last):
                return eval_v(st["mule_models"], Xte[last], Yte[last])

        run = dict(state=pop, batches=batch_fn, train_fn=train_fn, key=key,
                   eval_every=cfg.eval_every, eval_fn=eval_hook,
                   method=cfg.method, device=dev)
        if cfg.stream:
            # scenarios with a native generator stream it; the rest stream
            # the compacted schedule already built for the data partition
            generator = (scenario_generator(cfg.scenario, cfg.seed,
                                            cfg.n_mules, cfg.steps,
                                            colocation=colocation,
                                            device=dev)
                         if cfg.scenario else
                         compact_colocation(colocation, device=dev))
            run.update(generator=generator, cfg=pcfg, n_steps=cfg.steps,
                       chunk_len=cfg.stream_chunk or cfg.eval_every)
            engine = run_population_streamed
        else:
            run.update(colocation=colocation, cfg=pcfg)
            engine = run_population
        if cfg.distributed:
            dcfg = DistributedConfig(
                pop=pcfg, rebucket_every=cfg.rebucket_every,
                rebucket_threshold=cfg.rebucket_threshold)
            dist_eval = cfg.mode == "fixed"
            run.update(state=to_distributed_state(pop, dcfg),
                       mesh=_mule_mesh(cfg.n_mules), dcfg=dcfg,
                       eval_every=cfg.eval_every if dist_eval else None,
                       eval_fn=eval_hook if dist_eval else None)
            if cfg.stream:
                run["chunk_len"] = cfg.stream_chunk or (
                    cfg.rebucket_every or (cfg.eval_every if dist_eval
                                           else 64))
            else:
                del run["cfg"]
                engine = run_population_distributed
        pop, aux = engine(**run)
        if cfg.distributed:
            # every rank holds its block of the mules: gather them, so
            # the metrics below see the whole population
            mesh, ax = run["mesh"], run["dcfg"].data_axis
            pop = {k: (interop.tree_map(
                lambda l: gather_global(l, mesh, 0, ax), v)
                if k.startswith("mule") else v) for k, v in pop.items()}
            aux = {**aux, "last_fid": gather_global(aux["last_fid"], mesh,
                                                    0, ax)}
        evals = aux["evals"]
        traces = ([] if evals is None else
                  [(int(s), float(a)) for s, a in
                   zip(aux["eval_steps"],
                       evals.reshape(len(evals), -1).mean(1).tolist())])
        last_fid = aux["last_fid"]
        final_models = (pop["fixed_models"] if cfg.mode == "fixed"
                        else pop["mule_models"])
        state.update(engine=engine.__name__, run=run, population=pop,
                     aux=aux)
    state["run_s"] = _clock(dev) - t1

    # ---------------- final metrics (pre/post local) --------------------------
    if cfg.mode == "fixed":
        pre = eval_fixed_models(final_models)
        post_models = final_models
        for e in range(cfg.post_local_epochs):
            ke = fold_in(fold_in(key, -1), e)
            keys = split(fold_in(ke, 1), n_clients, dev)
            post_models = torch.func.vmap(train_fn)(
                post_models, sampler(fold_in(ke, 0)), keys)
        post = eval_fixed_models(post_models)
    else:
        pre = eval_mobile_models(final_models, np.arange(n_clients)
                                 % cfg.n_fixed if federated else last_fid)
        post = pre
    state["final_models"] = final_models

    result = {
        "config": dataclasses.asdict(cfg),
        "trace": traces,
        "pre_local_acc": float(np.mean(pre)),
        "post_local_acc": float(np.mean(post)),
        "wall_s": time.time() - t_start,
    }
    return result, state


# ---------------------------------------------------------------------------
# seed sweeps
# ---------------------------------------------------------------------------


def _stack_wrap_pad(arrs: List[torch.Tensor]) -> torch.Tensor:
    """Stack per-seed ``[P, N, ...]`` tensors whose N varies across seeds.

    Shorter pools are padded to the longest with uniformly drawn repeats
    (``np.random.default_rng(0)``, the reference's draws), so no sample is
    systematically over-weighted; a repeat still tilts that seed's
    sampling and eval weights slightly, which is why per-seed sweep metrics
    can differ from an unpadded ``run_experiment`` at the same seed.
    """
    rng = np.random.default_rng(0)
    n = max(a.shape[1] for a in arrs)
    out = []
    for a in arrs:
        idx = np.concatenate([np.arange(a.shape[1]),
                              rng.integers(0, a.shape[1], n - a.shape[1])])
        out.append(a[:, torch.as_tensor(idx, device=a.device)])
    return torch.stack(out)


def run_sweep_experiment(cfg: ExperimentConfig, seeds, methods=None,
                         device="cuda") -> Dict:
    """Seed-averaged multi-method sweep on the lane-batched engine.

    Builds each seed's data, schedule and pretrained population as
    ``run_experiment`` builds them (the data pools padded to one size by
    ``_stack_wrap_pad``), stacks them on a leading seed axis, and replays
    every requested method with ``run_sweep``, or with
    ``run_sweep_distributed`` over the ranks of the world when
    ``cfg.distributed`` (the mule blocks gathered back after the run; no
    re-bucketing). The federated baselines (fedavg/cfl/fedas) are
    round-based and not on the engine: request those through
    ``run_experiment``.

    Returns the reference's keys: ``config``, ``seeds``, ``eval_steps`` and,
    per method, ``acc`` ``[S][E]`` and ``mean_acc`` ``[E]`` (the eval
    curves), ``final_acc`` ``[S]`` and ``mean_final_acc``; and ``wall_s``.
    """
    cfg = with_scenario(cfg)
    return run_sweep_with_models(cfg, seeds, model_fns(cfg), methods,
                                 device)[0]


def run_sweep_with_models(cfg: ExperimentConfig, seeds,
                          fns: Tuple[Callable, ...], methods=None,
                          device="cuda") -> Tuple[Dict, Dict[str, Any]]:
    """``run_sweep_experiment``'s body with ``fns = (init_fn, train_fn,
    eval_fn)`` handed in. Returns ``(result, state)``; ``state`` holds
    ``pre_models`` (stacked ``[S, ...]``), ``pretrain_s`` and ``run_s``
    (seconds, the device synchronised), ``run`` (``run_sweep``'s keyword
    arguments but ``methods``) and ``out`` (its ``{method: (final,
    aux)}``)."""
    t_start = time.time()
    if cfg.distributed and cfg.rebucket_every:
        raise ValueError("the seed sweep over the ranks does not re-bucket: "
                         "rebucket_every runs one seed through "
                         "run_experiment")
    if cfg.stream:
        raise ValueError("the seed sweep replays materialized schedules; "
                         "stream runs one seed through run_experiment")
    methods = list(methods or [cfg.method])
    bad = [m for m in methods if m not in METHODS_MOBILE]
    if bad:
        raise ValueError(f"not engine methods: {bad}; pick from "
                         f"{METHODS_MOBILE} (the federated baselines run "
                         f"through run_experiment)")
    dev = resolve_device(device)
    cfg = with_scenario(cfg)
    seeds = [int(s) for s in seeds]
    init, train_fn, eval_fn = fns
    eval_v = torch.func.vmap(eval_fn)

    # -- per-seed assembly, stacked on a leading [S] axis ---------------------
    cos, places, data = [], [], []
    for s in seeds:
        scfg = dataclasses.replace(cfg, seed=s)
        co, mule_space, mule_area = mobility_tensors(scfg)
        arrays, n_clients = _experiment_data(scfg, mule_space, mule_area,
                                             dev)
        cos.append(co)
        places.append((mule_space, mule_area))
        data.append(arrays)
    context = tuple(_stack_wrap_pad([d[i] for d in data]) for i in range(4))

    # -- per-seed pretraining, as run_with_models does it, on the padded pools
    t0 = _clock(dev)
    pre, pops = [], []
    pcfg = _population_config(cfg)
    for i, s in enumerate(seeds):
        gen = torch.Generator(device=dev)
        gen.manual_seed(s)
        models = make_pretrain(
            train_fn, cfg, n_clients,
            lambda seed, step=None, i=i: sample_batches(
                seed, context[0][i], context[1][i], cfg.batch))(
            _stack([init(gen) for _ in range(n_clients)]), s + 7)
        pre.append(models)
        pops.append(_engine_population(dataclasses.replace(cfg, seed=s),
                                       pcfg, init, models, *places[i], dev))
    t1 = _clock(dev)

    def batch_fn(seed, t, ctx):
        return _side(cfg, sample_batches(seed, ctx[0], ctx[1], cfg.batch))

    if cfg.mode == "fixed":
        def eval_hook(st, last, ctx):
            return eval_v(st["fixed_models"], ctx[2], ctx[3])
    else:
        def eval_hook(st, last, ctx):
            return eval_v(st["mule_models"], ctx[2][last], ctx[3][last])

    run = dict(states=stack_trees(pops),
               colocations=stack_colocations(cos, dev), batches=batch_fn,
               train_fn=train_fn, cfg=pcfg, keys=[s + 100 for s in seeds],
               eval_every=cfg.eval_every, eval_fn=eval_hook, context=context,
               device=dev)
    if cfg.distributed:
        # the lanes inside each rank's block of the mules; as in
        # run_with_models, only fixed mode evaluates during the run (a
        # rank's mule block would see only its own mules' last places)
        dcfg = DistributedConfig(pop=pcfg)
        dist_eval = cfg.mode == "fixed"
        run.update(states=stack_trees([to_distributed_state(p, dcfg)
                                       for p in pops]),
                   dcfg=dcfg, mesh=_mule_mesh(cfg.n_mules),
                   eval_every=cfg.eval_every if dist_eval else None,
                   eval_fn=eval_hook if dist_eval else None)
        del run["cfg"]
        out = run_sweep_distributed(methods=tuple(methods), **run)
        mesh, ax = run["mesh"], dcfg.data_axis

        def whole(final, aux):
            # every rank holds its block of the mules (axis 1): gather them
            final = {k: (interop.tree_map(
                lambda l: gather_global(l, mesh, 1, ax), v)
                if k.startswith("mule") else v) for k, v in final.items()}
            return final, {**aux, "last_fid": gather_global(
                aux["last_fid"], mesh, 1, ax)}
        out = {m: whole(*fa) for m, fa in out.items()}
    else:
        out = run_sweep(methods=tuple(methods), **run)
    t2 = _clock(dev)

    result_methods, eval_steps = {}, np.zeros((0,), int)
    for m, (final, aux) in out.items():
        eval_steps = aux["eval_steps"]
        evals = aux["evals"]
        acc = (evals.cpu().numpy().mean(axis=-1) if evals is not None
               else np.zeros((len(seeds), 0)))                   # [S, E]
        facc = np.array([eval_hook(
            {side: {k: v[i] for k, v in final[side].items()}
             for side in ("mule_models", "fixed_models")},
            aux["last_fid"][i], tuple(c[i] for c in context)
        ).cpu().numpy().mean() for i in range(len(seeds))])      # [S]
        result_methods[m] = {
            "acc": acc.tolist(),
            "mean_acc": acc.mean(axis=0).tolist(),
            "final_acc": facc.tolist(),
            "mean_final_acc": float(facc.mean()),
        }
    result = {
        "config": dataclasses.asdict(cfg),
        "seeds": seeds,
        "eval_steps": [int(x) for x in eval_steps],
        "methods": result_methods,
        "wall_s": time.time() - t_start,
    }
    state = {"pre_models": stack_trees(pre), "pretrain_s": t1 - t0,
             "run_s": t2 - t1, "run": run, "out": out}
    return result, state
