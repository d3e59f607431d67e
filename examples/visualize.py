"""Sort visualization — the reference's `visualize` example
(examples/visualize/visualize.cpp: OpenCL sort + Vulkan point-cloud render,
unsorted on top / sorted below, heat-map colors, sort-time overlay, and a
click-to-regenerate live loop at visualize.cpp:801-854) re-imagined:

- default: headless PNG render (CI-safe, Agg backend);
- ``--interactive``: a live matplotlib window — **click** (or press ``r``)
  to regenerate fresh keys and re-sort on the accelerator, press ``d`` to
  cycle the dataset distribution, ``q`` to quit.  This is the reference's
  regenerate-on-click loop with the render backend swapped for matplotlib
  (no Vulkan interop: keys come back to the host to be drawn).

Run: python examples/visualize.py [out.png] [--interactive]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np

N = 4096  # the reference visualizes 4096 u32 keys


def _setup():
    import jax
    import jax.numpy as jnp

    from radix_sort import sort
    from radix_sort.parallel.runtime import enable_compile_cache

    enable_compile_cache()

    fn = jax.jit(sort)
    fn(jnp.zeros((N,), jnp.uint32)).block_until_ready()  # compile once
    return jnp, fn


def _make_keys(dist_idx: int, seed: int):
    from radix_sort import datasets

    dists = datasets.make_datasets(np.uint32, seed=seed)
    d = dists[dist_idx % len(dists)]
    return d.name, d.generate(N)


def _sort_timed(jnp, fn, keys):
    t0 = time.perf_counter()
    out = np.asarray(fn(jnp.asarray(keys)))
    return out, (time.perf_counter() - t0) * 1e3


def _draw(fig, axes, name, keys, sorted_keys, ms):
    x = np.arange(N)
    for ax, ys, title in ((axes[0], keys, f"unsorted — {name}"),
                          (axes[1], sorted_keys, f"sorted ({ms:.2f} ms)")):
        ax.clear()
        ax.scatter(x, ys, c=ys, cmap="inferno", s=2)
        ax.set_title(title)
        ax.set_ylim(0, 2**32)
    fig.suptitle(f"radix_sort — {N} u32 keys"
                 "  [click/r: regenerate, d: distribution, q: quit]")


def main_headless(out_path: str = "visualize.png"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    jnp, fn = _setup()
    name, keys = _make_keys(1, seed=int(time.time()) % 2**31)
    sorted_keys, ms = _sort_timed(jnp, fn, keys)

    fig, axes = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    _draw(fig, axes, name, keys, sorted_keys, ms)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    print(f"wrote {out_path} (sort time {ms:.2f} ms)")


def main_interactive():
    import matplotlib
    import matplotlib.pyplot as plt

    if matplotlib.get_backend().lower() == "agg":
        print("no GUI backend available — falling back to headless PNG "
              "(set MPLBACKEND to a GUI backend for the live loop)")
        return main_headless()

    jnp, fn = _setup()
    state = {"dist": 1, "seed": int(time.time()) % 2**31}
    fig, axes = plt.subplots(2, 1, figsize=(10, 6), sharex=True)

    def regen():
        state["seed"] += 1
        name, keys = _make_keys(state["dist"], state["seed"])
        sorted_keys, ms = _sort_timed(jnp, fn, keys)
        _draw(fig, axes, name, keys, sorted_keys, ms)
        fig.canvas.draw_idle()

    def on_click(event):
        if event.inaxes is not None:
            regen()

    def on_key(event):
        if event.key == "r":
            regen()
        elif event.key == "d":
            state["dist"] += 1
            regen()
        elif event.key == "q":
            plt.close(fig)

    fig.canvas.mpl_connect("button_press_event", on_click)
    fig.canvas.mpl_connect("key_press_event", on_key)
    regen()
    plt.show()


if __name__ == "__main__":
    argv = sys.argv[1:]
    if "--interactive" in argv:
        main_interactive()
    else:
        main_headless(*[a for a in argv if not a.startswith("-")][:1])
