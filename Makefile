# Convenience targets (the reference's cpu/makefile + gpu/makefile analog:
# here the device code is jit-compiled, so `make` only builds the native
# host runtime and drives tests/benchmarks).
#
#   make test     CPU test suite (GPU kernels in the Pallas interpreter)
#   make gpu-test card-only tests, on a machine with a GPU
#   make smoke    chip_smoke.py: the served path end to end on one GPU
#   make bench    bench.py: frame times of the served path on the GPU

PY ?= python

.PHONY: all native test gpu-test smoke bench sweep clean

all: native

native: parallel_ray_tracer_tpu/native/librtnative.so

parallel_ray_tracer_tpu/native/librtnative.so: parallel_ray_tracer_tpu/native/src/rtnative.cpp
	g++ -O3 -march=native -std=c++17 -shared -fPIC $< -o $@

# Full suite, split into a few pytest processes (a single process can
# SIGABRT inside XLA compilation under accumulated compile load on small
# hosts — see scripts/run_tests.sh).
test: native
	PY=$(PY) bash scripts/run_tests.sh

gpu-test: native
	$(PY) -m pytest tests/ -q -m gpu

smoke: native
	$(PY) chip_smoke.py

bench: native
	$(PY) bench.py

sweep: native
	$(PY) scripts/sweep.py

clean:
	rm -f parallel_ray_tracer_tpu/native/librtnative.so
