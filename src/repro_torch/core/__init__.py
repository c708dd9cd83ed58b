"""Graph build, sampling, layer programs and the executors."""
