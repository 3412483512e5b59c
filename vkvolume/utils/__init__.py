import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """Directory of the persistent XLA compilation cache:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.cache/jax``.

    The path is part of every cache key, so it is fixed — independent of
    the working directory — and every entry point shares one cache."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return os.path.abspath(env)
    return os.path.join(_REPO, ".cache", "jax")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache at ``compile_cache_dir()``
    so a later process serves the frame and map-build programs from disk
    instead of recompiling them. Call before the first jit; returns the
    directory."""
    import jax

    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
