# Reference-equivalent make targets (reference: Makefile:12-42).
# The compute core is JAX plus CUDA kernels that build themselves with nvcc
# on first use on a GPU; `make` builds the native host library,
# `make test_launch` runs the reference golden test, `make chip_smoke` checks
# the whole path on an NVIDIA GPU.

PYTHON ?= python3
DATA := stringdecomposer_tpu/test_data

.PHONY: all test chip_smoke test_launch install uninstall clean

all:
	$(MAKE) -C stringdecomposer_tpu/runtime/native

test:
	$(PYTHON) -m pytest tests/ -q -m "not slow"

# the card check: golden bytes, serve, 3 Mbp router-vs-scan bytes and the
# gpu-marked kernel parity tests, in one process on one NVIDIA GPU
chip_smoke:
	$(PYTHON) chip_smoke.py

test_launch:
	rm -rf /tmp/sd_golden_test && \
	$(PYTHON) -m stringdecomposer_tpu $(DATA)/read.fa \
	  $(DATA)/DXZ1_star_monomers.fa -o /tmp/sd_golden_test --second-best && \
	grep -q "Thank you for using StringDecomposer!" /tmp/sd_golden_test/stringdecomposer.log && \
	diff -q /tmp/sd_golden_test/final_decomposition.tsv $(DATA)/final_decomposition_fc89af8.tsv && \
	echo "test_launch: OK (byte-identical to the reference golden TSV)"

install:
	$(PYTHON) -m pip install . --no-build-isolation

uninstall:
	$(PYTHON) -m pip uninstall -y stringdecomposer-tpu

clean:
	rm -f stringdecomposer_tpu/runtime/native/libsdnative.so
	rm -rf stringdecomposer_tpu/ops/cuda/build
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
