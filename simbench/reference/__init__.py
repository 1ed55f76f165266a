"""The plain reference of the benchmark's ``correct``.

Plain PyTorch, written from upstream BlueSky's equations (ISA
atmosphere, the OpenAP-style envelope, the autopilot and kinematics of
``traffic.py``, state-based conflict detection, MVP resolution and
resume-nav of ``asas``): it imports nothing of the program it judges.
It runs in any float dtype; ``correct`` runs it in float64, and the
control runs it in bfloat16 in the program's place.
"""
