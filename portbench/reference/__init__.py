"""Plain PyTorch references of the cells' steps.

Frozen copies of the star stencil's and the D3Q15 step's arithmetic.  They
import nothing of the program, pad their inputs themselves, and work in
blocks of z planes so that a step at the paper's domain fits beside the
program's outputs.
"""
