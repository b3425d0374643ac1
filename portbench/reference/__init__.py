"""The plain reference that decides ``correct``: f32 PyTorch, written apart
from the port and importing nothing of it (``model``), the reference's first
jobs and the control's product (``train``), and the numbers compared with
their limits (``compare``)."""
