"""The benchmark's plain reference: numpy only, nothing of the program.

``model.Model`` says which answers a correct store may give; ``store.
ReferenceStore`` is the control, the reference served in the program's
place with one guarantee broken.
"""
