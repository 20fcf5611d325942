"""The offline stage of the port: scene normalization of an IDR case
(``preprocess_cameras``)."""
