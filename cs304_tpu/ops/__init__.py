"""Device compute kernels: log-domain math, Gaussian/GMM emissions, MFCC, Viterbi, DTW."""
