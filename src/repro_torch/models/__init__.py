"""The LM template's model zoo in PyTorch (the dense family so far).

A port of the JAX package's ``repro.models``: parameters are declared once
with their shapes and mesh axes (``common.ParamDef``); ``transformer
.DecoderModel`` is an ``nn.Module`` over them in the reference's layouts,
and ``lm`` builds the serving steps.
"""
