"""A2J's training step over a device-resident training set of 176x176 crops,
driven the way ``Trainer.fit`` drives it, as ``traffic/train.py`` drives
the PCA regressors: each epoch's ``aligned_epoch_indices`` order, ``_take``,
``_epoch_generators``, the ``lr_of_ep`` schedule, the losses fetched once
at each epoch's end; no validation or snapshots.  The step augments the
crops (K5), makes the anchor targets through each crop's transform and the
camera, and runs the dilated ResNet-50, the three heads, the anchors' vote
and loss, and Adam with weight decay.

Parameters (the traffic mix, then the cell's file):
  batch_size      samples a step
  train_frames    rows of the resident training set (NYU's 72,757)
  pool_frames     rendered frames the rows are tiled from
Set-up builds one trainer and state and runs the first three steps of
epoch 0 through the window's own call; the reference
(``reference/a2j.py``) follows those three from the same weights, rows and
draws, and the window continues from them.  Inside the window the
reference follows three more steps, from a step of epoch 0 drawn from the
seed: the program's parameters, Adam's moments and count and the
augmentation generator's state are copied before them.  The gradient
compared is the one Adam got, weight decay included, from its first
moment before and after the first followed step; the decay Adam added at
the first step (that gradient less ``.grad``) is compared with the
reference's, ``decay_gap``.  The fault ``no_decay`` trains with no weight
decay.

The rate is samples over the seconds from the first timed step to a
synchronize after the last step the window started.  The per-layer readers
get the step's flops (``models/a2j_flops.py``), the steps and seconds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_torch.lib import frames, system
from bench_torch.models.a2j_flops import train_step_flops
from bench_torch.reference import a2j as reference
from bench_torch.reference import train as train_ref

FOLLOWED = 3  # steps the reference follows, at the start and inside the window
# the window's followed steps begin by this step of epoch 0: at about 5-8 steps a
# second on one H100, inside the first 25 s of the 51 s window
FOLLOW_BY = 128


def run(ctx):
    # the a2j family first: a program without it fails here, before set-up
    from deepprior_tpu_torch.models.a2j import A2J, A2JConfig
    from deepprior_tpu_torch.train.optimizer import lr_of_ep
    from deepprior_tpu_torch.train.prefetch import aligned_epoch_indices
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    tr = cfg["train"]
    b, n = int(p["batch_size"]), int(p["train_frames"])

    def net_config(dtype):
        return A2JConfig(num_joints=cfg["num_joints"], input_hw=cfg["input_hw"], dtype=dtype)

    with torch.device("meta"):
        layout = A2J(net_config(torch.float32)).state_dict()
    depth, com, joints = frames.render_pool(cfg, system.rng(ctx.seed, "frames"),
                                            int(p["pool_frames"]))
    data = reference.training_set(cfg, depth, com, joints, n, dev)
    del depth
    weights = system.draw_weights(layout, system.stream_seed(ctx.seed, "pose_net"), dev)
    ctx.mark("inputs")
    tc = TrainConfig(batch_size=b, learning_rate=tr["learning_rate"], optimizer=tr["optimizer"],
                     aug_modes=tuple(tr["aug_modes"]), sigma_com=tr["sigma_com"],
                     sigma_sc=tr["sigma_sc"], rot_range=tr["rot_range"],
                     seed=system.stream_seed(ctx.seed, "train"), model_has_dropout=False)
    with torch.device("meta"):
        net = A2J(net_config(system.compute_dtype(ctx.precision)))
    net = net.to_empty(device=dev)
    net.load_state_dict(weights)
    decay = 0.0 if ctx.fault == "no_decay" else tr["weight_decay"]
    trainer = Trainer(net, tc, system.program_camera(cfg), device=dev, weight_decay=decay)
    state = trainer.init_state(state_dict=weights)
    td = TrainData(**{k: data[k] for k in TrainData._fields})
    if ctx.fault == "state_unchanged":
        state.optimizer.step = lambda *a, **k: None
    elif ctx.fault == "half_batch":
        take = trainer._take
        trainer._take = lambda d, idx: take(d, idx[: len(idx) // 2])

    ctx.mark("program")
    sched = lr_of_ep(tc.learning_rate)
    order = np.random.default_rng(tc.seed)
    per_epoch = -(-n // b)
    # epoch 0's augmentation seed, as Trainer._epoch_generators derives it
    aug_seed = int(np.random.SeedSequence([tc.seed, 0]).generate_state(2, np.uint64)[0])

    def epoch(e):
        aug, drop = trainer._epoch_generators(e)
        idx = aligned_epoch_indices(order, n, b)
        return float(sched(e)), aug, drop, torch.from_numpy(idx.reshape(per_epoch, b)).to(dev)

    def step(s):
        nonlocal state
        state, loss = trainer._train_step_core(state, trainer._take(td, idxs[s]), aug, drop, lr)
        return loss

    lr, aug, drop, idxs = epoch(0)
    names = [k for k, _ in state.model.named_parameters()]
    opt = state.optimizer

    def moments(slot):
        return {k: opt.state[q][slot].clone() for k, q in zip(names, state.model.parameters())}

    def params():
        return {k: q.detach().clone() for k, q in zip(names, state.model.parameters())}

    def grads():
        return {k: q.grad.detach().clone() for k, q in zip(names, state.model.parameters())}

    mu0 = moments("mu")
    first_losses = [step(0)]
    raw1, mu1 = grads(), moments("mu")
    first_losses += [step(s) for s in range(1, FOLLOWED)]
    after = params()
    rows = idxs[:FOLLOWED].clone()
    # the window's followed steps begin at a step of epoch 0 drawn from the seed
    at = int(system.rng(ctx.seed, "follow").integers(
        FOLLOWED, max(FOLLOWED, min(per_epoch, FOLLOW_BY) - FOLLOWED) + 1))
    if at + FOLLOWED > per_epoch:
        raise ValueError(f"an epoch of {per_epoch} steps is too short to follow")
    win = {"losses": []}
    losses = list(first_losses)
    ctx.tracer.warm(dev)
    failed = 0

    def end_epoch():
        nonlocal failed
        if losses:
            costs = torch.stack(losses).cpu().numpy()
            failed += int((~np.isfinite(costs)).sum())
            losses.clear()

    ctx.sync()
    ctx.window_opens()
    s, e, steps = FOLLOWED, 0, 0
    starts = []  # of each step
    t0 = time.perf_counter()
    # the window runs its time, and on to the end of the followed steps
    while steps < at or time.perf_counter() - t0 < ctx.seconds:
        following = e == 0 and at <= s < at + FOLLOWED
        if following and s == at:
            with ctx.tracer.span("follow"):
                win.update(start=params(), mu=moments("mu"), nu=moments("nu"),
                           count=opt.param_groups[0]["count"].clone(), gen=aug.get_state(),
                           rows=idxs[at:at + FOLLOWED].clone(), lr=lr)
        starts.append(time.perf_counter())
        with ctx.tracer.span("step"):
            losses.append(step(s))
        steps += 1
        if following:
            with ctx.tracer.span("follow"):
                win["losses"].append(losses[-1])
                if s == at:
                    win["mu1"] = moments("mu")
                if s == at + FOLLOWED - 1:
                    win["end"] = params()
        s += 1
        ctx.tracer.poll()
        if s == per_epoch:
            with ctx.tracer.span("epoch_end"):
                end_epoch()
            e, s = e + 1, 0
            lr, aug, drop, idxs = epoch(e)
    ctx.sync()
    t_end = time.perf_counter()
    window_s = t_end - t0
    ctx.window_closed()
    ctx.tracer.stop()
    host_steps, host_s = ctx.tracer.after_stop(starts, t_end)
    end_epoch()
    first = [float(v) for v in first_losses]
    win_losses = [float(v) for v in win["losses"]]
    delta = {k: after[k] - weights[k] for k in names}
    win_delta = {k: win["end"][k] - win["start"][k] for k in names}
    ctx.values.update(steps=len(host_steps) if host_s else steps, window_s=host_s or window_s,
                      batch=b, step_flops=train_step_flops(layout, b, cfg["num_joints"],
                                                           cfg["input_hw"]))
    del trainer, state, net, opt, td, after
    failed += sum(not np.isfinite(v) for v in first + win_losses)

    def check():
        gen = torch.Generator(device=dev).manual_seed(aug_seed)
        g1 = train_ref.gradient_from_moments(mu0, mu1)
        out = train_ref.compare(first, g1, delta, *reference.follow(
            cfg, weights, data, rows, float(sched(0)), gen, steps=FOLLOWED))
        out["decay_gap"] = reference.decay_gap(g1, raw1, weights, tr["weight_decay"])
        gen = torch.Generator(device=dev)
        gen.set_state(win["gen"])
        late = train_ref.compare(win_losses, train_ref.gradient_from_moments(
            win["mu"], win["mu1"]), win_delta, *reference.follow(
            cfg, win["start"], data, win["rows"], float(win["lr"]), gen,
            adam_state=(win["mu"], win["nu"], int(win["count"])), steps=FOLLOWED))
        out.update({"window_" + k: v for k, v in late.items()})
        return out

    return {"metrics": {"train_samples_per_s": steps * b / window_s},
            "attempted": steps, "failed": failed, "check": check,
            "notes": {"steps": steps, "epochs_begun": e + 1, "window_s": window_s,
                      "steps_by_second": np.bincount(
                          (np.asarray(starts) - t0).astype(int)).tolist(),
                      "first_losses": first, "followed_from_step": at}}
