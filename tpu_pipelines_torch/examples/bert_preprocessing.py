"""BERT preprocessing module (the port's copy of
``examples/bert/bert_preprocessing.py``): tokenize text on the host.

The ``tokenize`` analyzer learns the vocabulary in the full pass and emits
fixed-length ``input_ids`` on the host; the attention mask and the label
cast are numeric, so the Transform evaluates them on the device.
"""

MAX_LEN = 64
VOCAB_SIZE = 4096


def preprocessing_fn(inputs, tft):
    ids = tft.tokenize(inputs["text"], max_len=MAX_LEN, vocab_size=VOCAB_SIZE)
    return {
        "input_ids": ids,
        "attention_mask": tft.greater(ids, 0),
        "label": tft.cast(inputs["label"], "int32"),
    }
