"""Microbench: what does per-bounce ray sorting cost on the device?

Strategies at N=640k, 17 payload f32 words per ray:
  a) argsort + per-array 1D gathers (x[perm] on component-major arrays)
  b) one multi-operand lax.sort carrying all payloads with the key
  c) argsort + row gathers on (N,3) arrays (round-1 shape, the slow one)
  d) scatter-add of (N,3) contrib into img at sorted lanes (per-bounce cost
     that riding-the-ray accumulation would remove)

Usage: python tools/sort_bench.py
"""
import time

import numpy as np
import jax
import jax.numpy as jnp

from pathtracer.utils import jaxcache

jaxcache.enable()

N = 640_000
R = 20  # in-graph repetitions

rng = np.random.default_rng(0)
key0 = jnp.asarray(rng.integers(0, 1 << 20, N, dtype=np.int32))
cols = [jnp.asarray(rng.random(N, dtype=np.float32)) for _ in range(17)]
mat = jnp.stack(cols[:3], axis=1)  # (N, 3) row-major
img = jnp.zeros((N, 3), jnp.float32)
lane = jnp.asarray(rng.permutation(N).astype(np.int32))


def timeit(name, fn, *args):
    out = jax.jit(fn)(*args)
    jax.tree.map(np.asarray, out)  # force
    t0 = time.perf_counter()
    out = jax.jit(fn)(*args)
    jax.tree.map(np.asarray, out)
    dt = (time.perf_counter() - t0) / R
    print(f"{name:>34}: {dt*1e3:8.2f} ms", flush=True)


def loop(body):
    def f(*args):
        def step(c, _):
            return body(*c), 0
        c, _ = jax.lax.scan(step, args, None, length=R)
        return c
    return f


def a_argsort_gather(key, *cs):
    perm = jnp.argsort(key, stable=True)
    return (key[perm],) + tuple(c[perm] for c in cs)


def b_multisort(key, *cs):
    out = jax.lax.sort((key,) + cs, num_keys=1, is_stable=True)
    return out


def c_rowgather(key, m):
    perm = jnp.argsort(key, stable=True)
    return key[perm], m[perm]


def d_scatter(img, lane, contrib):
    return img.at[lane].add(contrib), lane + 1, contrib


def e_argsort_only(key):
    return (jnp.argsort(key, stable=True) ^ key,)


def e_scatter1d(i0, i1, i2, lane, c):
    return (
        i0.at[lane].add(c[:, 0]),
        i1.at[lane].add(c[:, 1]),
        i2.at[lane].add(c[:, 2]),
        lane + 1,
        c,
    )


def f_lanesort(img, lane, c):
    out = jax.lax.sort((lane, c[:, 0], c[:, 1], c[:, 2]), num_keys=1)
    return img + jnp.stack(out[1:4], axis=1), lane, c


timeit("argsort only", loop(lambda k: (jnp.argsort(k, stable=True) ^ k,)), key0)
timeit("a) argsort + 17x 1D gather", loop(a_argsort_gather), key0, *cols)
timeit("b) lax.sort 17 payloads", loop(b_multisort), key0, *cols)
timeit("c) argsort + (N,3) row gather", loop(c_rowgather), key0, mat)
timeit("d) (N,3) scatter-add", loop(d_scatter), img, lane, mat)
timeit("e) 3x 1D scatter-add", loop(e_scatter1d), img[:, 0], img[:, 1], img[:, 2], lane, mat)
timeit("f) lane-keyed 4-op sort + add", loop(f_lanesort), img, lane, mat)
