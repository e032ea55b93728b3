"""T5 seq2seq preprocessing (the port's copy of
``examples/t5/t5_preprocessing.py``): tokenize source and target."""

MAX_IN = 64
MAX_OUT = 32
VOCAB_SIZE = 4096


def preprocessing_fn(inputs, tft):
    src = tft.tokenize(inputs["source"], max_len=MAX_IN,
                       vocab_size=VOCAB_SIZE)
    tgt = tft.tokenize(inputs["target"], max_len=MAX_OUT,
                       vocab_size=VOCAB_SIZE)
    return {
        "inputs": src,
        "input_mask": tft.greater(src, 0),
        "targets": tgt,
        "target_mask": tft.greater(tgt, 0),
    }
