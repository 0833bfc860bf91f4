"""Window drivers, one module a kind (``epochs`` today), each with
``run(ctx) -> result``; ``benchmark.manifest.driver`` loads them by name."""
