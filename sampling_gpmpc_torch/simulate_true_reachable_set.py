"""Monte-Carlo ground-truth reachable set (B1), the port's entry point.

Counterpart of ``benchmarking/simulate_true_reachable_set.py``: a saved
input trajectory is replayed ``--repeats`` times, each repeat drawing
``ns`` fresh GP dynamics realizations that condition step by step on their
own draws (``reachability.forward_sample_rollout``; ref:
benchmarking/simulate_true_reachable_set.py:118-259), under the ancillary
feedback the plan assumed.  Results are written in chunks of ``--chunk``
repeats, ``X_traj_list_<k>.pkl``, each a numpy array
``(repeats_in_chunk, T+1, ns, nx)``.

A repeat's realizations condition only on their own draws, so ``B``
repeats are one rollout of ``B * ns`` realizations (``--batch`` repeats a
rollout): the same distribution as ``B`` rollouts, in the layout the card
wants.  Realization ``b * ns + i`` of a batch is realization ``i`` of its
repeat ``b``.  A rollout's repeats may span several chunks (at the
defaults, 1000 repeats are 40 chunks of 25).  Each chunk draws all its
repeats' draws at once from its own ``torch.Generator``, seeded from the
config's seed and the chunk's index, so the pickles do not depend on
``--batch``.

Usage (from the repository root):
    python -m sampling_gpmpc_torch.simulate_true_reachable_set \\
        -param params_pendulum1D_samples --repeats 10000 \\
        [--data experiments/.../data.pkl] [--batch 1000] [--chunk 25]
    python -m sampling_gpmpc_torch.simulate_true_reachable_set \\
        --device cpu --repeats 4   # float64 on the CPU

CUDA float32 by default (``--device cpu`` runs float64; ``SGPMPC_DTYPE``
overrides either).  Prints sampled steps per second and, on the card, the
peak device memory.
"""

import argparse
import dataclasses
import os
import pickle
import time

import numpy as np

# repeats per rollout.  At params_pendulum1D_samples (ns = 70, T = 17) on
# an H100 (80 GB), 1000 repeats (70,000 realizations) peak at 10.9 GiB of
# device memory and sample 2.24 M steps/s; 2000 and 5000 peak at 21.8 and
# 54.5 GiB (the peak grows with the batch) and sample no faster (1.94 M
# and 2.09 M steps/s), so 1000 is the default.
DEFAULT_BATCH = 1000


def chunk_generator(seed: int, chunk: int):
    """The draws of chunk ``chunk``: a generator seeded from both."""
    import torch
    return torch.Generator().manual_seed(seed * 1_000_003 + chunk)


def feedback(spec, data):
    """The ancillary feedback the plan assumed (u = U - K(x_eq - x)), or
    None: without it the Monte-Carlo tube is the open-loop reachable set
    (ref: simulate_forward_sampling_car.py:122)."""
    if spec.use_feedback and data.K_fb is not None:
        return {"K": data.K_fb, "x_eq": data.goal}
    return None


def batch_rollout(spec, env, hyp, gp0, x0, U, repeats: int, generator=None,
                  use_feedback=None, eps=None):
    """``repeats`` Monte-Carlo repeats as one rollout.

    Args:
        gp0: ``init_gp_state`` of the batch spec (ns = repeats * spec.ns,
            capacity T).
        eps: optional draws (T, repeats * ns, g_ny, 1, Ty).
    Returns:
        (repeats, T+1, ns, nx) tensor.
    """
    from sampling_gpmpc_torch.reachability import forward_sample_rollout
    bspec = dataclasses.replace(spec, ns=repeats * spec.ns)
    X, _ = forward_sample_rollout(bspec, env, hyp, gp0, x0, U, generator,
                                  use_feedback=use_feedback, eps=eps)
    T1 = X.shape[0]
    return X.reshape(T1, repeats, spec.ns, spec.nx).transpose(0, 1)


def simulate(spec, env, hyp, x0, U, repeats: int, chunk: int, batch: int,
             out_dir: str, device, dtype, use_feedback=None):
    """Write ``repeats`` repeats in chunks of ``chunk`` to ``out_dir``.

    Rollouts take ``batch`` repeats each, across chunk boundaries: a
    rollout's draws are the slices of its repeats out of their chunks'
    draws, and its result is split back into the chunks' pickles.

    Returns {"seconds", "sampled_steps_per_s", "nonfinite"}: the
    wall clock covers the rollouts and the copies to the host, not the
    pickles.
    """
    import torch

    from sampling_gpmpc_torch import agent as agent_mod
    T = len(U)
    os.makedirs(out_dir, exist_ok=True)
    starts = list(range(0, repeats, chunk))
    gps, draws, parts = {}, {}, {}
    seconds, nonfinite = 0.0, 0
    for r0 in range(0, repeats, batch):
        B = min(batch, repeats - r0)
        # the chunks this rollout's repeats come from, and each one's slice
        pieces = []
        for k in range(r0 // chunk, (r0 + B - 1) // chunk + 1):
            n_chunk = min(chunk, repeats - starts[k])
            if k not in draws:
                # the chunk's draws, realization-major in repeat order:
                # the same whatever the batch size
                draws[k] = agent_mod.truncated_normal(
                    (T, n_chunk * spec.ns, spec.g_ny, 1, spec.Ty),
                    spec.gp.beta, chunk_generator(spec.seed, k), device,
                    dtype)
            a = max(r0, starts[k]) - starts[k]
            b = min(r0 + B, starts[k] + n_chunk) - starts[k]
            pieces.append((k, a, b))
        eps = torch.cat([draws[k][:, a * spec.ns:b * spec.ns]
                         for k, a, b in pieces], dim=1)
        if B not in gps:
            gps[B] = agent_mod.init_gp_state(
                dataclasses.replace(spec, ns=B * spec.ns), env, device,
                dtype, capacity=T, hyp=hyp)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        X = batch_rollout(spec, env, hyp, gps[B], x0, U, B,
                          use_feedback=use_feedback, eps=eps).cpu().numpy()
        seconds += time.perf_counter() - t0
        i = 0
        for k, a, b in pieces:
            parts.setdefault(k, []).append(X[i:i + b - a])
            i += b - a
            n_chunk = min(chunk, repeats - starts[k])
            if b < n_chunk:
                continue
            del draws[k]
            Xk = np.concatenate(parts.pop(k))
            nonfinite += int((~np.isfinite(Xk).all(axis=(1, 3))).sum())
            with open(os.path.join(out_dir, f"X_traj_list_{k}.pkl"),
                      "wb") as f:
                pickle.dump(Xk, f)
    return {"seconds": seconds,
            "sampled_steps_per_s": repeats * spec.ns * T / seconds,
            "nonfinite": nonfinite}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Monte-Carlo ground truth "
                                     "(PyTorch)")
    parser.add_argument("-param", default="params_pendulum1D_samples")
    parser.add_argument("--repeats", type=int, default=100)
    parser.add_argument("--steps", type=int, default=None,
                        help="propagation steps (default: the horizon H)")
    parser.add_argument("--chunk", type=int, default=25,
                        help="repeats per X_traj_list_<k>.pkl")
    parser.add_argument("--batch", type=int, default=DEFAULT_BATCH,
                        help="repeats per rollout")
    parser.add_argument("--data", default=None,
                        help="data.pkl whose input_traj[0][:T] is replayed; "
                             "default: zero inputs")
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default) | cpu | cuda:N")
    args = parser.parse_args(argv)

    import torch

    from sampling_gpmpc_torch import setup
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays

    device, dtype = setup.resolve(args.device)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params, spec, data = load_problem(
        os.path.join(here, "params", args.param + ".yaml"))
    env = make_env(spec, params)
    hyp = GPHyperArrays.from_spec(spec.gp, device, dtype)
    T = args.steps or spec.H
    if args.data:
        with open(args.data, "rb") as f:
            U = np.asarray(pickle.load(f)["input_traj"][0])[:T]
        T = U.shape[0]
    else:
        U = np.zeros((T, spec.nu))
    out_dir = args.out or os.path.join(here, "experiments", "reachability",
                                       args.param + "_mc")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    r = simulate(spec, env, hyp, data.start, U, args.repeats, args.chunk,
                 min(args.batch, args.repeats), out_dir, device, dtype,
                 feedback(spec, data))
    peak = (f", peak device memory "
            f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB"
            if device.type == "cuda" else "")
    print(f"{args.repeats} repeats x {spec.ns} realizations x {T} steps in "
          f"{r['seconds']:.3f}s ({r['sampled_steps_per_s']:.0f} sampled "
          f"steps/s, batch {min(args.batch, args.repeats)} repeats, "
          f"non-finite realizations {r['nonfinite']}{peak}) on {device} "
          f"{dtype} -> {out_dir}", flush=True)


if __name__ == "__main__":
    main()
