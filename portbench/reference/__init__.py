"""Plain PyTorch references the benchmark holds the port against.

They import nothing of the port and take nothing the port made: each
makes its inputs again from the seed (``portbench.weights``) and reads the
program's outputs only to judge them. Products run in float32 with TF32
off (``full_f32``); ``precision="fp8"`` rounds every product's operands to
float8 e4m3 at a per-tensor scale first, which is the control that
computes one step below the configured bfloat16.
"""
