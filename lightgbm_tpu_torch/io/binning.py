"""Bin and missing-value type codes (reference bin.h BinType /
MissingType), with the values the model text's ``decision_type`` bits
carry.  The bin mappers come with the training slice of the port."""


class MissingType:
    NONE = 0
    ZERO = 1
    NAN = 2


class BinType:
    NUMERICAL = 0
    CATEGORICAL = 1
