"""Runtime sanitizers for the serving stack.

Copy of the runtime half of ``vnsum_tpu/analysis``: the lockdep-style
lock-order detector (:mod:`sanitizers`) that wraps the serve/obs locks
when ``VNSUM_SANITIZERS`` asks for it. The AST lint rules and the
hot-loop transfer guard are not ported (ROADMAP A14).
"""
