"""The benchmark of the PyTorch and CUDA port (`exastencils_tpu_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json on the CUDA device and prints one JSON
line; see portbench/harness.py.  Nothing here imports JAX or the JAX
package.
"""
