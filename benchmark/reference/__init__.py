"""The plain float32 reference of the stage-1 step (``model``, ``step``).
It imports nothing of the program under test."""
