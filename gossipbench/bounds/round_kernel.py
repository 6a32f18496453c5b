"""The least time one ``round_kernel`` launch (one period of every node)
needs: ``mega_kernel``'s count at R = 1 (see ``mega_kernel.py``), a
frozen copy of the program's ``costmodel.kernel_bound`` for a frame-less
configuration."""

from gossipbench.bounds import mega_kernel


def bound_s(cfg: dict, traffic: dict, n: int) -> float:
    if traffic["R"] != 1:
        raise ValueError("round_kernel runs one period a launch (R = 1)")
    return mega_kernel.launch(cfg, n, 1)["bound_s"]
