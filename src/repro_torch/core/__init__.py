"""The paper's Figure-1 decision pipeline: confidence -> policy -> router."""
