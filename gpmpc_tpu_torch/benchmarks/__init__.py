"""Measurement entry points of the port: the kernel probes P1
(`kernel_ablate`) and P2 (`kernel_probe`), timed by `chain`. Each runs as
`python -m gpmpc_tpu_torch.benchmarks.<name> --out DIR` on the card, or with
`run(device='cpu')` on the CPU, where its times mean nothing."""
