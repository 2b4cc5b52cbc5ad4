"""The plain references that decide ``correct``: torch and numpy only.

Nothing here imports the program under test (``ozimmu_tpu_torch``), the
JAX package or the harness; each reference is handed the inputs that the
harness made and the outputs that the program returned, and works every
number out again from the inputs.
"""
