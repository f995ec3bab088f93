"""The plain reference: plain PyTorch in f64, written from the published
equations of the exact GP, the moment-matched rollout (Girard; Quinonero-
Candela, eqs. 21/31) and the risk-sensitive cost. It imports nothing of the
program and takes nothing the program made: it fits its own GPs from the
benchmark's inputs and reads the program's outputs only to judge them."""
