"""Plain fp32 PyTorch reference of the configurations the benchmark runs.

It follows the published models (HF ``LlavaForConditionalGeneration`` and
``LlavaNextForConditionalGeneration`` on a Mistral decoder) and the paper's
Dropout Decoding step, one prompt at a time and with no cache layout, kernel
or padding of the program's.  It imports nothing of ``dropoutdecoding_tpu``
or ``dropoutdecoding_tpu_torch`` and reads nothing the program made: it
takes the benchmark's weights and inputs and computes everything else again.
"""
