"""Taxi preprocessing module: the module-file contract (the port's copy of
``examples/taxi/taxi_preprocessing.py``)."""


def preprocessing_fn(inputs, tft):
    out = {}
    out["miles_z"] = tft.scale_to_z_score(inputs["trip_miles"])
    out["fare_01"] = tft.scale_to_0_1(inputs["fare"])
    out["log_fare_z"] = tft.scale_to_z_score(tft.log1p(inputs["fare"]))
    out["hour_bucket"] = tft.bucketize(inputs["trip_start_hour"], 4)
    out["company_id"] = tft.compute_and_apply_vocabulary(
        inputs["company"], num_oov_buckets=2
    )
    out["payment_onehot"] = tft.one_hot(
        tft.compute_and_apply_vocabulary(inputs["payment_type"], num_oov_buckets=0),
        depth=2,
    )
    out["is_cash"] = tft.equal(inputs["payment_type"], "Cash")
    out["tip_ratio"] = tft.clip(inputs["tips"] / inputs["fare"], 0.0, 1.0)
    out["label_big_tip"] = tft.greater(inputs["tips"] / inputs["fare"], 0.1)
    return out
