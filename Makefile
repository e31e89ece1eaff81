# Convenience targets. Tests run on the CPU (tests/conftest.py sets 8
# virtual devices and float64); `make chip` runs the GPU smoke test.

CPU_ENV = env JAX_PLATFORMS=cpu

.PHONY: test test-default test-smoke chip native bench bench-baseline samples clean

test:            # everything incl. the slow tier (~45 min on this host)
	$(CPU_ENV) python -m pytest tests/ -x -q

test-default:    # slow tier deselected (~30 min)
	$(CPU_ENV) python -m pytest tests/ -x -q -m "not slow"

test-smoke:      # dev-loop tier: core solver/parity/scene/live (~5 min)
	$(CPU_ENV) python -m pytest tests/test_system.py tests/test_parity.py \
	  tests/test_prox.py tests/test_svd.py tests/test_live.py \
	  tests/test_scene.py tests/test_geometry.py -x -q

chip:            # one GPU; `python chip_smoke.py --four` on four
	python chip_smoke.py

native:
	$(MAKE) -C admm_elastic_tpu/native

bench:
	python bench.py --steps 10

bench-baseline:
	bash tools/bench_reference.sh 5

samples:
	$(CPU_ENV) python samples/singlenode.py
	$(CPU_ENV) python samples/singletet.py
	$(CPU_ENV) python samples/windyflag.py --steps 30
	$(CPU_ENV) python samples/bunnyexpand.py --steps 30
	$(CPU_ENV) python samples/poordillo.py --steps 30
	$(CPU_ENV) python samples/plinkopony.py --steps 30

clean:
	$(MAKE) -C admm_elastic_tpu/native clean
	find . -name __pycache__ -type d | xargs rm -rf
