"""Host utilities of the port: the tokenizer and the native host runtime.

Copies of ``icl_speech_text_llm_tpu/utils/tokenization.py`` and
``utils/native.py`` (which loads the repository's ``runtime/libiclrt.so``),
so that the port imports nothing of the JAX package.
"""
