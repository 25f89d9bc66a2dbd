"""PCA analyses of the source-model features (port of
``experiments/pca_analysis/``): the images at each PC's poles, the
PC1–PC2 view of the coarse labels and the class-size distribution of a
label CSV."""
